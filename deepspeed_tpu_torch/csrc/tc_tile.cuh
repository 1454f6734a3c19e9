// Tensor-core building blocks for Hopper (sm_90a) kernels: swizzled shared
// tiles, the cp.async copies that fill a ring of them (or TMA copies
// completing an mbarrier), wgmma shared-memory descriptors, the wgmma
// instructions themselves (m64n64k16; m64n64k16 and m64n128k16 with both
// operands in shared memory and B MN-major) and the accumulator ->
// A-fragment conversion (with the hi/lo split that keeps an fp32 operand to
// ~2^-16, and for fp16 the running row scale that keeps the split above
// fp16's subnormal range; or one cast, stochastic_mode's function); for
// fp32 operands, the 3xTF32 pieces (section "tf32"): wgmma m64nNk8 tf32 over
// split tiles and mma.sync m16n8k8 tf32 fed from accumulators; and the tests
// of B9's sub-block masks (section "blocksparse tiles").
//
// Tile layout. A [R][D] tile of 16-bit elements (R a multiple of 8, D a
// multiple of 64; a head dim of 96 is kept as 128, kPadded, its last 32
// columns zero) is kept as D / 64 column panels of R rows x 128 bytes,
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

// The tile width that holds a head dim of D: whole 64-column panels. At
// D 96 the last panel's columns 96-127 are zero-filled (load_tile_async):
// products with K = D step over D / 16 k slices only, and the columns a
// product with N = D gives past D are never stored.
template <int D> constexpr int kPadded = (D + kPanelCols - 1) / kPanelCols * kPanelCols;
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

// ----------------------------------------------------------------- TMA
// mbarrier of `count` arrivals (one thread initialises; all wait after a
// fence and a barrier).
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` of TMA transfers in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile("{\n.reg .pred P1;\nLAB_WAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
               "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n"
               :: "r"(bar), "r"(parity) : "memory");
}
// The box of a 2-D tensor map at coordinates (c0 innermost, c1) into shared
// memory at `dst`, completing `bar`'s expected bytes (out-of-bounds
// elements arrive as zeros).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* tensor_map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%3, %4}], [%2];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(tensor_map)), "r"(bar), "r"(c0),
                  "r"(c1)
               : "memory");
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
// zero-filled, and so are columns D .. DP of a tile DP wide (kPadded).
// Threads `tid` of `nthreads` share the chunks.
template <typename T, int R, int D, int DP = D>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const T* src, long long stride,
                                                int r0, int n, int tid, int nthreads) {
  constexpr int chunks = DP * static_cast<int>(sizeof(T)) / 16;  // per tile row
  constexpr int real = D * static_cast<int>(sizeof(T)) / 16;     // read from src
  for (int idx = tid; idx < R * chunks; idx += nthreads) {
    const int r = idx / chunks, c = idx % chunks;
    const bool in = r0 + r < n && c < real;
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

// 16 bytes from registers into shared memory (a swizzled tile built in place).
__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
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
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
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

#define DS_TC_ACC64                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define DS_TC_OUT64(d)                                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
  "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
  "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
  "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),       \
  "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),       \
  "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),       \
  "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128 fp32) += A B with A K-major and B MN-major (transpose flag 1),
// both in shared memory: B's two 64-column panels lie LBO apart (desc_mnmajor
// of panel 0). Accumulator entries 32 p .. 32 p + 31 are panel p's, laid out
// as a 64 x 64 accumulator's.
template <typename T> __device__ __forceinline__ void wgmma_ss_mn128(float (&d)[64], uint64_t da,
                                                                     uint64_t db);

template <> __device__ __forceinline__ void wgmma_ss_mn128<__nv_bfloat16>(float (&d)[64],
                                                                          uint64_t da,
                                                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DS_TC_ACC64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : DS_TC_OUT64(d)
      : "l"(da), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_ss_mn128<__half>(float (&d)[64], uint64_t da,
                                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " DS_TC_ACC64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : DS_TC_OUT64(d)
      : "l"(da), "l"(db), "r"(1));
}

#undef DS_TC_ACC64
#undef DS_TC_OUT64

// d (64 x 64 fp32) += A B with A K-major and B MN-major (transpose flag 1),
// both in shared memory: one 64-column panel of B (desc_mnmajor).
template <typename T> __device__ __forceinline__ void wgmma_ss_mn64(float (&d)[32], uint64_t da,
                                                                    uint64_t db);

template <> __device__ __forceinline__ void wgmma_ss_mn64<__nv_bfloat16>(float (&d)[32],
                                                                         uint64_t da,
                                                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DS_TC_ACC32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : DS_TC_OUT32(d)
      : "l"(da), "l"(db), "r"(1));
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

// ----------------------------------------------------------------- tf32 (fp32 operands)
// An fp32 tile [R][D] keeps the same panels: a 128-byte panel row holds 32
// fp32 columns, so D / 32 panels (D 96: three, no zero-filled panel), and a
// k8 step of a tf32 product spans 32 bytes, as a k16 step of a 16-bit one:
// load_tile_async<float, R, D>, tile_offset and desc_kmajor serve unchanged.
// For tf32, wgmma reads both shared-memory operands K-major only (the
// transpose bits exist for f16 / bf16 alone); products whose B would be
// MN-major run on mma.sync m16n8k8 instead, with B gathered per thread from
// the same tiles (mma_acc_tf32x3).
//
// 3xTF32: a b = big_a big_b + big_a small_b + small_a big_b + O(2^-21 |a b|)
// with big = tf32(x), small = tf32(x - big) (x - big is exact in fp32).

// x rounded to TF32 (10 explicit mantissa bits; nearest, ties away from
// zero): the value the tensor cores multiply, its low 13 bits zero.
__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ float4 ld_shared16f(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}

// The 3xTF32 split of an fp32 tile of `bytes` bytes whose raw values lie at
// `src`: big parts to `big`, small parts to `small`, in the same layout (src
// may be either: each thread reads a 16-byte chunk before it writes it).
// The layout is a bijection of 16-byte chunks, so a linear pass covers it.
__device__ __forceinline__ void split_tile_tf32(uint32_t src, uint32_t big, uint32_t small,
                                                int bytes, int tid, int nthreads) {
  for (int off = tid * 16; off < bytes; off += nthreads * 16) {
    const float4 x = ld_shared16f(src + off);
    const float4 b = make_float4(to_tf32(x.x), to_tf32(x.y), to_tf32(x.z), to_tf32(x.w));
    const float4 s = make_float4(to_tf32(x.x - b.x), to_tf32(x.y - b.y), to_tf32(x.z - b.z),
                                 to_tf32(x.w - b.w));
    st_shared16(big + off, make_uint4(__float_as_uint(b.x), __float_as_uint(b.y),
                                      __float_as_uint(b.z), __float_as_uint(b.w)));
    st_shared16(small + off, make_uint4(__float_as_uint(s.x), __float_as_uint(s.y),
                                        __float_as_uint(s.z), __float_as_uint(s.w)));
  }
}

#define DS_TC_ACC16                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define DS_TC_OUT16(d)                                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
  "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// d (64 x N fp32, N 32 or 64) = [d +] A B for one k8 step, A and B tf32
// K-major in shared memory. `accumulate` 0 ignores d's old value.
template <int N> __device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t da,
                                                            uint64_t db, int accumulate);

template <> __device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], uint64_t da,
                                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " DS_TC_ACC32
      ", %32, %33, p, 1, 1;\n}\n"
      : DS_TC_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <> __device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], uint64_t da,
                                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " DS_TC_ACC16
      ", %16, %17, p, 1, 1;\n}\n"
      : DS_TC_OUT16(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef DS_TC_ACC16
#undef DS_TC_OUT16

// d (64 x N) [+]= a b in 3xTF32 over K = 8 * ksteps: a (64 rows) and b (N
// rows) K-major fp32 tiles split into big and small parts (split_tile_tf32);
// per k step small_a big_b, big_a small_b, then big_a big_b. One commit
// group's worth of wgmma; the caller fences and commits.
template <int N, int RA, int RB>
__device__ __forceinline__ void wgmma_tf32x3(float (&d)[N / 2], uint32_t a, uint32_t a_small,
                                             uint32_t b, uint32_t b_small, int ksteps) {
#pragma unroll
  for (int ks = 0; ks < ksteps; ++ks) {
    const uint64_t da = desc_kmajor<RA>(a, ks), db = desc_kmajor<RB>(b, ks);
    wgmma_tf32<N>(d, desc_kmajor<RA>(a_small, ks), db, ks > 0);
    wgmma_tf32<N>(d, da, desc_kmajor<RB>(b_small, ks), 1);
    wgmma_tf32<N>(d, da, db, 1);
  }
}

// d (16 x 8 fp32) += a (16 x 8) b (8 x 8), tf32, one warp (mma.sync: HMMA).
// Fragments (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g,
// t + 4), a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g); d0, d1 (g,
// 2 t, 2 t + 1), d2, d3 (g + 8, 2 t, 2 t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], float b0,
                                         float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

// The mma.sync A fragments (big, small) of k step kk of a wgmma fp32
// accumulator x (the warp's 16 rows; columns [8 kk, 8 kk + 8)). The thread
// holds columns 8 kk + 2 t and 8 kk + 2 t + 1 of its rows g and g + 8, and
// they become the fragment's k indices t and t + 4 as they lie: k index c of
// the step stands for column 8 kk + 2 c (c < 4) or 8 kk + 2 (c - 4) + 1, and B
// is read in the same order (b_offset_tf32). No shuffle is needed.
template <int N>
__device__ __forceinline__ void acc_to_a_tf32(const float (&x)[N], int kk, uint32_t (&big)[4],
                                              uint32_t (&small)[4]) {
  const float v[4] = {x[4 * kk], x[4 * kk + 2], x[4 * kk + 1], x[4 * kk + 3]};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float b = to_tf32(v[j]);
    big[j] = __float_as_uint(b);
    small[j] = __float_as_uint(to_tf32(v[j] - b));
  }
}

// Byte offset, in a swizzled fp32 tile of R rows (rows are the product's K),
// of B fragment element b0 (half 0: row 8 kk + 2 t) or b1 (half 1: row
// 8 kk + 2 t + 1) of n tile j (column 8 j + g), in acc_to_a_tf32's k order.
// A warp's 32 loads hit 32 banks: the swizzle spreads the four rows' chunks.
template <int R>
__device__ __forceinline__ uint32_t b_offset_tf32(int kk, int j, int lane, int half) {
  const int row = 8 * kk + 2 * (lane & 3) + half, col = 8 * j + (lane >> 2);
  return tile_offset<R>(row, col >> 2) + (col & 3) * 4;
}

// acc (NT n tiles of 16 x 8) += x B in 3xTF32 over K = 8 * ksteps: x a
// warp's 16 rows of a wgmma accumulator (acc_to_a_tf32), B an fp32 tile of R
// rows (K) split into big and small parts (columns are N), given by generic
// pointers into shared memory (plain 4-byte loads: the compiler may batch
// them between barriers, and keeps them inside). acc[j] holds columns
// 8 j .. 8 j + 7 as a wgmma accumulator's entries 4 j .. 4 j + 3.
template <int R, int NT, int N>
__device__ __forceinline__ void mma_acc_tf32x3(float (&acc)[NT][4], const float (&x)[N],
                                               const unsigned char* b,
                                               const unsigned char* b_small, int ksteps,
                                               int lane) {
#pragma unroll
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t ab[4], as[4];
    acc_to_a_tf32(x, kk, ab, as);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t o0 = b_offset_tf32<R>(kk, j, lane, 0), o1 = b_offset_tf32<R>(kk, j, lane, 1);
      const float b0 = *reinterpret_cast<const float*>(b + o0);
      const float b1 = *reinterpret_cast<const float*>(b + o1);
      const float s0 = *reinterpret_cast<const float*>(b_small + o0);
      const float s1 = *reinterpret_cast<const float*>(b_small + o1);
      mma_tf32(acc[j], as, b0, b1);
      mma_tf32(acc[j], ab, s0, s1);
      mma_tf32(acc[j], ab, b0, b1);
    }
  }
}

// Row r (0: g, 1: g + 8) of a warp's mma_acc_tf32x3 accumulator, times f,
// into `row` (the output row's column 0): columns 8 j + 2 t, + 1 as float2s.
template <int NT>
__device__ __forceinline__ void store_acc_tf32(float* row, const float (&acc)[NT][4], int r,
                                               float f, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    *reinterpret_cast<float2*>(row + 8 * j + 2 * (lane & 3)) =
        make_float2(acc[j][2 * r] * f, acc[j][2 * r + 1] * f);
}

#undef DS_TC_ACC32
#undef DS_TC_OUT32

// ----------------------------------------------------------------- blocksparse tiles
// B9's kernels walk 64-token tiles, each listed with the bit mask of its
// active block x block sub-blocks: bit r g + c for query sub-block r and key
// sub-block c, g = 64 / block sub-blocks a side (ops/cuda/blocksparse_attention.py
// tile_masks). Blocks of 64 and 128 cover whole tiles and test no bit (MASK
// false).

// Whether the entry of query t and key `key` is visible: under `causal` key
// <= t, and (MASK) its sub-block's bit of the tile's mask `bits` is set (qr
// and kc the query's and key's offsets in their 64-token tiles, `shift` =
// log2(block)).
template <bool MASK>
__device__ __forceinline__ bool visible(int t, int key, int causal, uint32_t bits, int qr, int kc,
                                        int shift, int g) {
  bool vis = !causal || key <= t;
  if constexpr (MASK) vis = vis && ((bits >> ((qr >> shift) * g + (kc >> shift))) & 1u);
  return vis;
}

// Whether a tile's mask `bits` has an active sub-block among key sub-blocks
// [lo, hi] (keys) or among query sub-blocks [lo, hi] (!keys).
__device__ __forceinline__ bool any_bits(uint32_t bits, int g, int lo, int hi, bool keys) {
  for (int r = 0; r < g; ++r)
    for (int c = lo; c <= hi; ++c)
      if ((bits >> (keys ? r * g + c : c * g + r)) & 1u) return true;
  return false;
}

// ----------------------------------------------------------------- three bf16 parts
// An fp32 operand v on the 16-bit tensor cores against exact integers (B6 /
// B7 / B8 with fp32 x): hi = the top 16 bits of v, mid = those of v - hi,
// lo = v - hi - mid; each difference is exact and lo keeps at most 8
// significant bits, so hi + mid + lo == v exactly. Two values at a time, as
// bf16 pairs (a in the low halves).
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  hi = __byte_perm(ua, ub, 0x7632);
  const float ra = a - __uint_as_float(ua & 0xffff0000u);
  const float rb = b - __uint_as_float(ub & 0xffff0000u);
  const uint32_t va = __float_as_uint(ra), vb = __float_as_uint(rb);
  mid = __byte_perm(va, vb, 0x7632);
  const float sa = ra - __uint_as_float(va & 0xffff0000u);
  const float sb = rb - __uint_as_float(vb & 0xffff0000u);
  lo = __byte_perm(__float_as_uint(sa), __float_as_uint(sb), 0x7632);
}

// Elements 8c .. 8c + 7 of a 256-byte fp32 row in shared memory (64 values):
// lane c of a quarter-warp reads half (c / 4) % 2 of its 32 bytes first, so
// the eight lanes' 16-byte reads cover the 32 banks once.
__device__ __forceinline__ void read_row8_f32(const unsigned char* row, int c, float (&x)[8]) {
  const int h = (c >> 2) & 1;
  const float4 a = *reinterpret_cast<const float4*>(row + 32 * c + 16 * h);
  const float4 b = *reinterpret_cast<const float4*>(row + 32 * c + 16 * (1 - h));
  const float4 lo4 = h ? b : a, hi4 = h ? a : b;
  x[0] = lo4.x; x[1] = lo4.y; x[2] = lo4.z; x[3] = lo4.w;
  x[4] = hi4.x; x[5] = hi4.y; x[6] = hi4.z; x[7] = hi4.w;
}

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

// The A fragment of k step `kk` of an fp32 accumulator cast once to T
// (stochastic_mode's function: ~2^-8 relative for bf16, 2^-11 for fp16).
template <typename T>
__device__ __forceinline__ void acc_to_a_single(const float (&x)[32], int kk, uint32_t (&a)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = pack2<T>(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
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
