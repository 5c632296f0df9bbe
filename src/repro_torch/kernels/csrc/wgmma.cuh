// wgmma building blocks shared by the port's tensor-core kernels
// (flash_attention.cu, ssd_scan.cu): bf16 tiles of 64 rows in shared
// memory under the 128-byte swizzle, their wgmma descriptors, the
// asynchronous products of one warpgroup (128 threads) with f32
// accumulators in registers, and the fences around them. Needs sm_90a.
//
// Accumulator fragment of m64nNk16 (f32): thread t of the warpgroup holds
// rows R = 16 (t / 32) + (t % 32) / 4 and R + 8; for each 8-column group i,
// d[4i], d[4i + 1] are row R, columns 8i + 2 (t % 4) + {0, 1}, and d[4i + 2],
// d[4i + 3] the same columns of row R + 8. The A fragment of a following
// m64nNk16 over K columns 16j .. 16j + 15 is then (pairs of) d[8j .. 8j + 7].
#pragma once

#include "common.cuh"

namespace wg {

typedef __nv_bfloat16 bf16;

constexpr int WG_THREADS = 128;      // one warpgroup
constexpr int TILE_ROWS = 64;        // rows of a tile: one m64 product
constexpr int COL_BLOCK = 64 * 128;  // one [64 rows, 64 cols] bf16 column block


// cp.async writes through the generic proxy, wgmma reads through the async one
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk ch of row r in a [64, Dh] bf16 tile: column
// blocks of 64 elements (128-byte rows, 8 KB each), and in each the 128-byte
// swizzle (chunk index XOR row mod 8) that TMA's SWIZZLE_128B and the wgmma
// descriptors' layout type 1 both name. Tile bases are 1024-byte aligned.
__device__ __forceinline__ uint32_t swizzled(int r, int ch) {
  return (ch >> 3) * COL_BLOCK + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

// Rows row0 .. row0 + 63 of a [S, DH] array (row stride ss elements) into a
// swizzled tile at dst; rows at or past S read as zero. Where DH is not a
// multiple of 64 the tile's rows span whole column blocks and the chunks
// past DH / 8 are not written (zero_pad).
template <int DH>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* g, long long ss,
                                          int row0, int S) {
  constexpr int CH = DH / 8;            // 16-byte chunks a row
#pragma unroll
  for (int it = 0; it < TILE_ROWS * CH / WG_THREADS; ++it) {
    const int i = threadIdx.x + it * WG_THREADS;
    const int r = i / CH, ch = i % CH, row = row0 + r;
    const bool ok = row < S;
    cp_async16(dst + swizzled(r, ch), g + (long long)(ok ? row : 0) * ss + ch * 8, ok);
  }
}

// Zero chunks DH/8 .. DP/8 - 1 of every row of a swizzled [64, DP] tile:
// the pad past a DH-wide row, which no copy of load_tile<DH> writes.
template <int DH, int DP>
__device__ __forceinline__ void zero_pad(uint32_t dst) {
  constexpr int CH0 = DH / 8, PAD = (DP - DH) / 8;
  static_assert(TILE_ROWS * PAD % WG_THREADS == 0, "DH and DP multiples of 16");
#pragma unroll
  for (int it = 0; it < TILE_ROWS * PAD / WG_THREADS; ++it) {
    const int i = threadIdx.x + it * WG_THREADS;
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n"
                 :: "r"(dst + swizzled(i / PAD, CH0 + i % PAD)), "r"(0) : "memory");
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
// K-major operands: SBO = 1024 (the next 8 rows), LBO unused. MN-major
// operands: LBO = the next 64-element column block, SBO = the next 8 rows.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from touching wgmma registers before the wait.
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N> __device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

#define WG_D8(d, o)                                                                  \
  "+f"(d[(o)]), "+f"(d[(o) + 1]), "+f"(d[(o) + 2]), "+f"(d[(o) + 3]), "+f"(d[(o) + 4]), \
      "+f"(d[(o) + 5]), "+f"(d[(o) + 6]), "+f"(d[(o) + 7])
#define WG_D32(d, o) WG_D8(d, (o)), WG_D8(d, (o) + 8), WG_D8(d, (o) + 16), WG_D8(d, (o) + 24)

// d[64 x 64] += A[64 x 16] (shared, K-major) * B[16 x 64] (shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d, 0)
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] (registers) * B[16 x 64] (shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] (registers) * B[16 x 128] (shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D32(d, 0), WG_D32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 192] += A[64 x 16] (registers) * B[16 x 192] (shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : WG_D32(d, 0), WG_D32(d, 32), WG_D32(d, 64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&h);
}

// d[64 x N] += A[64 x 16] * B[16 x N], both from shared memory and both
// MN-major (transpose bits set): A stored [K rows][64 M-contiguous], B
// [K rows][N-contiguous] in 64-element column blocks.
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : WG_D32(d, 0)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_tt(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : WG_D32(d, 0), WG_D32(d, 32)
      : "l"(da), "l"(db), "r"(1));
}

}  // namespace wg
