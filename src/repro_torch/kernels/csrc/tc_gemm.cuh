// Tensor-core GEMM core for block_matmul.cu and fused_dense.cu.
//
// out[M,N] = epilogue(x[M,K] @ w[K,N]) for row-major contiguous x, w, out
// of type T (float or __nv_bfloat16), with f32 accumulators in registers.
//
// Bound: at the main paths' shapes (K and N of 256 and up) the products
// carry far more operations than bytes, so the tensor-core rate bounds
// them; thin layers are bound by bytes.
//
// f32 (gemm_tf32x3, wgmma) keeps f32 accuracy by a three-way TF32 split
// ("3xTF32"). Each operand value v is split into hi = tf32(v) and
// lo = tf32(v - hi), both rounded to nearest (cvt.rna: without the explicit
// rounding of hi, v - hi would be 0 and the product one TF32 product, ~1e-3
// off). Then a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b: three TF32 products,
// the small ones first; lo_a lo_b (~2^-22 relative) is dropped. The block
// computes out^T = w^T x^T, so that each operand is in the layout wgmma
// wants without a transpose: w^T is the A operand, read from shared memory
// into registers and split there; x's rows are the K-major B operand, whose
// slice is split in shared memory once per stage (hi over x, lo into a
// plane of its own). The tensor cores round each sum toward zero, so the
// products of one BK slice go into a fresh accumulator (scale-d 0) that is
// then added in f32 to the running one: one long-lived tensor-core
// accumulator drifts toward zero by ~1e-3 at K = 4096 with N(0,1) operands.
//
// bf16 (gemm_bf16, mma.sync m16n8k16) runs one product a step, rounded to
// bf16 once, in the epilogue.
//
// Blocking: a block of 256 threads computes a 64 (rows of x) x 128 (columns
// of w) output tile, at 128 registers or fewer so that two blocks share an
// SM; f32 as two warpgroups of 64 columns x 64 rows (wgmma m64n64k8), bf16
// as 8 warps of 32 x 32. A ring of STAGES shared-memory stages, each a
// BK = 32 slice of x and of w, is fed by cp.async: the K loop waits only for
// the oldest stage while the next ones are in flight. x's f32 rows are
// 128-byte swizzled, as wgmma reads them; the other tiles' rows are padded so
// that a warp's fragment loads (ldmatrix, or 4-byte loads for f32 w) hit
// distinct banks. Copies are 16 bytes where x's, w's and out's rows and
// pointers allow (K, N and the weight tile width multiples of 16 bytes);
// otherwise the same kernel copies element by element (cp.async of 4 bytes
// in f32, plain loads for 2-byte bf16, which cp.async cannot copy). Ragged
// edges are zero-filled on load and masked on store, so the caller never
// pads.
//
// Column tiles: the weight is a relation of column tiles of width tile_w
// (the last one ragged). Each tile is cut into BN-wide column blocks, and no
// block straddles two weight tiles. Blocks run column block fastest, so the
// blocks that share a slice of x rows run together and x is read from
// device memory about once. Results are written with plain stores, no
// atomics, so repeated calls are bit-equal.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace rt {

constexpr int BM = 64, BN = 128, BK = 32, THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// one element into shared memory, zero where !ok
template <typename T>
__device__ __forceinline__ void copy_elem(T* dst, const T* src, bool ok) {
  if constexpr (sizeof(T) == 4) {
    hop::cp_async4(hop::smem_u32(dst), src, ok);
  } else {
    *reinterpret_cast<unsigned short*>(dst) =
        ok ? *reinterpret_cast<const unsigned short*>(src) : (unsigned short)0;
  }
}

// Rows [r0, r0 + R) and columns [c0, c0 + C) of the row-major matrix src
// (leading dimension ld) into the padded tile dst[R][LD]; rows at or past
// r_end and columns at or past c_end are zero.
template <typename T, bool VEC, int R, int C, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int ld, int r0, int r_end,
                                          int c0, int c_end) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;  // elements per copy
  static_assert(R * C / V % THREADS == 0, "copies per thread");
#pragma unroll
  for (int j = 0; j < R * C / V / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / (C / V), c = i % (C / V) * V;
    const bool ok = r0 + r < r_end && c0 + c < c_end;
    const T* s = ok ? src + (size_t)(r0 + r) * ld + c0 + c : src;
    if constexpr (VEC) hop::cp_async16(hop::smem_u32(dst + r * LD + c), s, ok);
    else copy_elem(dst + r * LD + c, s, ok);
  }
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on wgmma
// ---------------------------------------------------------------------------

namespace tf32 {
constexpr int STAGES = 3;
constexpr int W_LD = BN + 8;             // w rows: lanes (g, t) hit bank 8t + g
constexpr int X_BYTES = BM * BK * 4;     // x slice: BM rows of 128 bytes, swizzled
constexpr int W_BYTES = BK * W_LD * 4;
constexpr int STAGE_BYTES = X_BYTES + W_BYTES;  // a multiple of 1024
constexpr int SMEM = STAGES * STAGE_BYTES + X_BYTES + 1024;  // + lo plane, alignment
static_assert(X_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0, "swizzle atoms");
}  // namespace tf32

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// D[64 x 64] (+)= A[64 x 8] B[8 x 64], tf32 in, f32 accumulators; A from
// registers, B from shared memory, K-major; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t* a,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <bool VEC, typename Epilogue>
__global__ void __launch_bounds__(THREADS, 2)
gemm_tf32x3(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ out, int M, int N, int K, int tile_w, int subs,
            int col_blocks, Epilogue epi) {
  using namespace tf32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage s: x slice at s0 + s * STAGE_BYTES (1024-aligned), w slice after it
  const uint32_t s0 = (hop::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* base = smem_raw + (s0 - hop::smem_u32(smem_raw));
  float* lo_plane = reinterpret_cast<float*>(base + STAGES * STAGE_BYTES);
  const uint32_t lo_s = s0 + STAGES * STAGE_BYTES;

  const int cb = blockIdx.x % col_blocks, m0 = blockIdx.x / col_blocks * BM;
  const int tile = cb / subs, n0 = tile * tile_w + cb % subs * BN;
  const int n_end = min(min(tile * tile_w + tile_w, N), n0 + BN);
  if (n0 >= n_end) return;  // the whole block idles past a ragged tile
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int nr = 64 * wg + 16 * warp + g;  // the thread's rows of w^T: nr, nr + 8

  auto load = [&](int s, int k0) {
    // x: 16-byte chunk c of row r at swizzle(r, c); element copies inside it
    const uint32_t xs = s0 + s * STAGE_BYTES;
    constexpr int V = VEC ? 4 : 1;
#pragma unroll
    for (int j = 0; j < BM * BK / V / THREADS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / (BK / V), k = i % (BK / V) * V;
      const bool ok = m0 + r < M && k0 + k < K;
      const float* src = ok ? x + (size_t)(m0 + r) * K + k0 + k : x;
      const uint32_t dst = xs + hop::swizzle<128>(r, k / 4) + 4 * (k % 4);
      if constexpr (VEC) hop::cp_async16(dst, src, ok);
      else hop::cp_async4(dst, src, ok);
    }
    load_tile<float, VEC, BK, BN, W_LD>(
        reinterpret_cast<float*>(base + s * STAGE_BYTES + X_BYTES), w, N, k0, K, n0, n_end);
  };

  float acc[32], part[32];  // part: one slice's sum, overwritten (scale-d 0)
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = part[i] = 0.f;
  const int k_tiles = (K + BK - 1) / BK;
  // the ring: tiles 0 .. STAGES-2 in flight before the loop, one commit
  // group per tile (empty past the last) so the group count stays uniform
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load(s, s * BK);
    hop::cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    hop::cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's copies)
    // ... everyone's; every warp is past tile kt - 1, whose stage the next
    // load reuses and whose lo plane the split below overwrites
    __syncthreads();
    if (kt + STAGES - 1 < k_tiles) load((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BK);
    hop::cp_async_commit();

    // split the x slice: hi in place, lo into the lo plane (same layout)
    float4* xv = reinterpret_cast<float4*>(base + s * STAGE_BYTES);
#pragma unroll
    for (int j = 0; j < X_BYTES / 16 / THREADS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const float4 v = xv[i];
      uint32_t h[4], l[4];
      split_tf32(v.x, h[0], l[0]);
      split_tf32(v.y, h[1], l[1]);
      split_tf32(v.z, h[2], l[2]);
      split_tf32(v.w, h[3], l[3]);
      xv[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                          __uint_as_float(h[2]), __uint_as_float(h[3]));
      reinterpret_cast<float4*>(lo_plane)[i] =
          make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                      __uint_as_float(l[2]), __uint_as_float(l[3]));
    }
    hop::fence_proxy_async();  // wgmma reads the halves through the async proxy

    // A fragments of w^T for the four k8 steps: rows nr, nr + 8 at k t, t + 4
    const float* ws = reinterpret_cast<const float*>(base + s * STAGE_BYTES + X_BYTES);
    uint32_t ah[16], al[16];
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const float* a = ws + (8 * ks + t) * W_LD + nr;
      split_tf32(a[0], ah[4 * ks], al[4 * ks]);
      split_tf32(a[8], ah[4 * ks + 1], al[4 * ks + 1]);
      split_tf32(a[4 * W_LD], ah[4 * ks + 2], al[4 * ks + 2]);
      split_tf32(a[4 * W_LD + 8], ah[4 * ks + 3], al[4 * ks + 3]);
    }
    __syncthreads();  // every thread's halves of x are written

    hop::wgmma_fence();
    const uint32_t xh = s0 + s * STAGE_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {  // k8 steps: 32 bytes along the rows
      const uint64_t dh = hop::make_desc<128>(xh + 32 * ks, 16);
      const uint64_t dl = hop::make_desc<128>(lo_s + 32 * ks, 16);
      wgmma_tf32_n64(part, al + 4 * ks, dh, ks > 0);
      wgmma_tf32_n64(part, ah + 4 * ks, dl, 1);
      wgmma_tf32_n64(part, ah + 4 * ks, dh, 1);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(part);
    hop::fence_regs(ah);
    hop::fence_regs(al);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
  }
  hop::cp_async_wait<0>();

  // acc[4j + e] is out^T row nr + 8 (e / 2), column 8j + 2t + e % 2
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + nr + 8 * (e >> 1), m = m0 + 8 * j + 2 * t + (e & 1);
      if (m < M && n < n_end) out[(size_t)m * N + n] = epi(acc[4 * j + e], n);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync
// ---------------------------------------------------------------------------

namespace bf16 {
constexpr int STAGES = 4;
constexpr int WM = 32, WN = 32;           // warp tile; warps 2 (M) x 4 (N)
constexpr int MT = WM / 16, NT = WN / 8;  // m16 x n8 products per warp and k step
constexpr int A_LD = BK + 8;  // 80-byte rows: an ldmatrix phase hits 32 banks
constexpr int B_LD = BN + 8;  // 272-byte rows: likewise
constexpr int STAGE_ELEMS = BM * A_LD + BK * B_LD;
constexpr int SMEM = STAGES * STAGE_ELEMS * 2;
}  // namespace bf16

// C += A B, m16n8k16, bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += As[warp rows] @ Bs[warp columns] over one BK slice. Fragments (PTX
// ISA, mma.sync): lane = 4 g + t; A rows g and g + 8 at k pairs 2t and
// 2t + 8; B column g at the same k; C rows g and g + 8 at columns 2t and
// 2t + 1.
__device__ __forceinline__ void mma_stage(float (&acc)[bf16::MT][bf16::NT][4],
                                          const __nv_bfloat16* As,
                                          const __nv_bfloat16* Bs, int wm, int wn,
                                          int lane) {
  using namespace bf16;
  // lanes 0-15 address rows 0-15 of a 16 x 16 block, lanes 16-31 the same
  // rows 8 columns on: matrices 0-3 are A's a0-a3, or B's b0, b1 of n8
  // tile j and of tile j + 1
  const int row = lane % 16, col = 8 * (lane / 16);
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    uint32_t b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t r[4];
      hop::ldmatrix_x4_trans(hop::smem_u32(Bs + (ks + row) * B_LD + wn + 8 * j + col), r);
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t a[4];
      hop::ldmatrix_x4(hop::smem_u32(As + (wm + 16 * i + row) * A_LD + ks + col), a);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a, b[j]);
    }
  }
}

template <bool VEC, typename Epilogue>
__global__ void __launch_bounds__(THREADS, 2)
gemm_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
          __nv_bfloat16* __restrict__ out, int M, int N, int K, int tile_w, int subs,
          int col_blocks, Epilogue epi) {
  using namespace bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int cb = blockIdx.x % col_blocks, m0 = blockIdx.x / col_blocks * BM;
  const int tile = cb / subs, n0 = tile * tile_w + cb % subs * BN;
  const int n_end = min(min(tile * tile_w + tile_w, N), n0 + BN);
  if (n0 >= n_end) return;  // the whole block idles past a ragged tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BN / WN) * WM, wn = warp % (BN / WN) * WN;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto stage_a = [&](int s) { return smem + s * STAGE_ELEMS; };
  auto stage_b = [&](int s) { return smem + s * STAGE_ELEMS + BM * A_LD; };
  auto load = [&](int s, int k0) {
    load_tile<__nv_bfloat16, VEC, BM, BK, A_LD>(stage_a(s), x, K, m0, M, k0, K);
    load_tile<__nv_bfloat16, VEC, BK, BN, B_LD>(stage_b(s), w, N, k0, K, n0, n_end);
  };
  const int k_tiles = (K + BK - 1) / BK;
  // the ring, as in gemm_tf32x3
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load(s, s * BK);
    hop::cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    hop::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < k_tiles) load((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BK);
    hop::cp_async_commit();
    mma_stage(acc, stage_a(kt % STAGES), stage_b(kt % STAGES), wm, wn, lane);
  }
  hop::cp_async_wait<0>();

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + 16 * i + g + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = n0 + wn + 8 * j + 2 * t;
        __nv_bfloat16* o = out + (size_t)r * N + c;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        // VEC: N and n0 are multiples of 8, so c is even and the pair is
        // aligned and wholly in or out
        if (VEC && c < n_end) {
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(epi(v0, c), epi(v1, c + 1));
        } else if (!VEC) {
          if (c < n_end) *o = __float2bfloat16(epi(v0, c));
          if (c + 1 < n_end) o[1] = __float2bfloat16(epi(v1, c + 1));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel, typename T, typename Epilogue>
cudaError_t launch(Kernel kernel, int smem, const T* x, const T* w, T* out, int M,
                   int N, int K, int tile_w, int subs, int col_blocks, int blocks,
                   Epilogue epi, cudaStream_t stream) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, THREADS, smem, stream>>>(x, w, out, M, N, K, tile_w, subs, col_blocks,
                                            epi);
  return cudaGetLastError();
}

template <typename T, typename Epilogue>
cudaError_t launch_tc_gemm(const T* x, const T* w, T* out, int M, int N, int K,
                           int tile_w, Epilogue epi, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K < 0 || tile_w <= 0) return cudaErrorInvalidValue;
  const int n_tiles = (N + tile_w - 1) / tile_w, subs = (tile_w + BN - 1) / BN;
  const long long col_blocks = (long long)n_tiles * subs;
  const long long blocks = (long long)((M + BM - 1) / BM) * col_blocks;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  // 16-byte copies need every row and pointer of x and w, and each column
  // block's first column, on 16-byte boundaries
  constexpr int V = 16 / sizeof(T);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = K % V == 0 && N % V == 0 && tile_w % V == 0 && aligned(x) &&
                   aligned(w) && aligned(out);
  const int cbs = (int)col_blocks, nb = (int)blocks;
  if constexpr (sizeof(T) == 4) {
    return vec ? launch(gemm_tf32x3<true, Epilogue>, tf32::SMEM, x, w, out, M, N, K,
                        tile_w, subs, cbs, nb, epi, stream)
               : launch(gemm_tf32x3<false, Epilogue>, tf32::SMEM, x, w, out, M, N, K,
                        tile_w, subs, cbs, nb, epi, stream);
  } else {
    return vec ? launch(gemm_bf16<true, Epilogue>, bf16::SMEM, x, w, out, M, N, K,
                        tile_w, subs, cbs, nb, epi, stream)
               : launch(gemm_bf16<false, Epilogue>, bf16::SMEM, x, w, out, M, N, K,
                        tile_w, subs, cbs, nb, epi, stream);
  }
}

}  // namespace rt
