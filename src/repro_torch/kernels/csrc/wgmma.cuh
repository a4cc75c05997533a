// Hopper building blocks shared by the kernels: cp.async copies into shared
// memory and ldmatrix fragment loads (attention and the GEMM core), the
// shared-memory matrix descriptor of wgmma, the wgmma synchronisation
// instructions, and the attention kernels' m64nNk16 bf16 products
// (f32 accumulators in registers).
//
// Swizzled tiles. A tile is stored as atoms of rows of SW bytes (SW = 32,
// 64 or 128: the row width, 16, 32 or 64 bf16 values), 8 rows of an atom
// forming one swizzle pattern. Within an atom the 16-byte chunk c of row r
// lives at byte L ^ (((L >> 7) & (SW / 16 - 1)) << 4), L = r * SW + c * 16,
// which is the pattern the descriptor's layout type names when the atom
// starts on a multiple of 8 * SW bytes. A K-major operand (rows = M or N,
// contiguous along K) steps along K by adding 32 bytes to the start address
// inside an atom; an MN-major operand (rows = K, contiguous along M or N)
// steps along K by 16 rows.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; with ok false the
// 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
// 4 bytes, for operands whose rows are not 16-byte aligned (.ca: the
// 16-byte-only .cg does not take it)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// orders this thread's shared-memory writes before later async-proxy reads
// (wgmma reads its shared operands through the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// four 8x8 b16 matrices from shared memory, lanes 8i-8i+7 addressing the
// rows of matrix i; .trans hands each lane a column pair instead of a row
// pair (the B fragment of mma.sync from a row-major [K][N] tile)
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// byte offset of 16-byte chunk c of row r in a swizzled atom of SW-byte rows
template <int SW>
__device__ __forceinline__ uint32_t swizzle(int r, int c) {
  const uint32_t L = r * SW + c * 16;
  return L ^ (((L >> 7) & (SW / 16 - 1)) << 4);
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), layout type 1 / 2 / 3 = 128 / 64 / 32-byte
// swizzle. SBO is the distance between groups of 8 rows (8 * SW for dense
// atoms). For a K-major operand LBO is not used by swizzled layouts; for an
// MN-major one it is the distance between atoms along M or N, which a
// product no wider than one atom never crosses.
template <int SW>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  constexpr uint64_t layout = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(((8 * SW) >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// wgmma writes its accumulators (and reads a register A) asynchronously; an
// empty asm that "writes" each register after the wait keeps the compiler
// from moving their uses ahead of it or reusing them while it runs
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// 2^x on the special-function unit (flushes denormals; 2^-1e30 = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// S[64 x 64] (+)= A[64 x 16] B[16 x 64], A (Q) and B (K) from shared memory,
// both K-major; scale_d = 0 overwrites S.
template <int OFF, int NR>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[NR], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O[64 x 16] += A[64 x 16] B[16 x 16], A (P in bf16) from registers, B (V)
// from shared memory, MN-major (transpose bit set).
template <int OFF, int NR>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[NR], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 32] += A[64 x 16] B[16 x 32], A (P in bf16) from registers, B (V)
// from shared memory, MN-major (transpose bit set).
template <int OFF, int NR>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[NR], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 64] += A[64 x 16] B[16 x 64], A (P in bf16) from registers, B (V)
// from shared memory, MN-major (transpose bit set).
template <int OFF, int NR>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[NR], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

}  // namespace hop
