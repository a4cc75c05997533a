// Shared-memory tiled GEMM core for block_matmul.cu and fused_dense.cu.
//
// out[M,N] = epilogue(x[M,K] @ w[K,N]) for row-major contiguous x, w, out
// of type T (float or __nv_bfloat16). Every product is a full-f32 fmaf into
// an f32 accumulator, one k after the other: no tensor cores and no TF32,
// so f32 inputs keep f32 accuracy. bf16 inputs are read as bf16, widened to
// f32 for the arithmetic, and the result is rounded back to bf16.
//
// Blocking: a 256-thread block computes a BM x BN = 128 x 128 output tile;
// each thread owns an 8 x 8 sub-tile at rows ty + 16*i, cols tx + 16*j, so
// shared-memory reads of a warp hit distinct banks or broadcast. A BK = 8
// slice of x and w is staged in shared memory per step of the K loop.
// Ragged edges are masked on load (zero fill) and on store, so the caller
// never pads.
//
// Column tiles: the weight is a relation of column tiles of width tile_w
// (the last one ragged). Grid column blockIdx.y walks tile after tile, and
// within a tile its BN-wide slices; no block straddles two weight tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace rt {

constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8, THREADS = 256;
constexpr int PAD = 4;  // As row padding: stores of a warp hit 32 banks

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, typename Epilogue>
__global__ void __launch_bounds__(THREADS)
tiled_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ out, int M, int N, int K, int tile_w,
                  int subs, Epilogue epi) {
  __shared__ float As[BK][BM + PAD];  // x slice, transposed: As[k][m]
  __shared__ float Bs[BK][BN];
  const int tile = blockIdx.y / subs, sub = blockIdx.y % subs;
  const int n0 = tile * tile_w + sub * BN;
  const int n_end = min(min(tile * tile_w + tile_w, N), n0 + BN);
  const int m0 = blockIdx.x * BM;
  if (n0 >= n_end) return;  // the whole block idles past a ragged tile
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < BM * BK / THREADS; ++r) {
      const int i = tid + r * THREADS;
      const int m = i / BK, k = i % BK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < BK * BN / THREADS; ++r) {
      const int i = tid + r * THREADS;
      const int k = i / BN, n = i % BN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < n_end) ? to_f32(w[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < n_end) out[(size_t)gm * N + gn] = from_f32<T>(epi(acc[i][j], gn));
    }
  }
}

template <typename T, typename Epilogue>
cudaError_t launch_tiled_gemm(const T* x, const T* w, T* out, int M, int N,
                              int K, int tile_w, Epilogue epi,
                              cudaStream_t stream) {
  const int n_tiles = (N + tile_w - 1) / tile_w;
  const int subs = (tile_w + BN - 1) / BN;
  const dim3 grid((M + BM - 1) / BM, n_tiles * subs);
  tiled_gemm_kernel<T, Epilogue><<<grid, THREADS, 0, stream>>>(
      x, w, out, M, N, K, tile_w, subs, epi);
  return cudaGetLastError();
}

}  // namespace rt
