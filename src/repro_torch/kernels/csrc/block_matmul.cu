// block_matmul: x[M,K] @ w[K,N] over the weight's column-tile relation.
//
// Replaces the TPU kernel src/repro/kernels/block_matmul/kernel.py
// (block_matmul_pallas), the fused realization of rule R3-1's
// tensor-relational matmul.
//
// Bound on the H100: operations. At the main path's shape (1320 x 4096 @
// 4096 x 2048) the product does 22 GFLOP against 66 MB of traffic, far above
// the card's FLOP-per-byte balance, and f32 parity at 1e-4 rules out the
// TF32 tensor cores, so the ceiling is the non-tensor f32 FMA rate. The
// design keeps the FMA units fed from registers: a 128 x 128 block tile with
// an 8 x 8 register tile per thread reuses each shared-memory value eight
// times (tiled_gemm.cuh).
#include "tiled_gemm.cuh"

namespace bm {
struct Identity {
  __device__ __forceinline__ float operator()(float acc, int) const { return acc; }
};
}  // namespace bm

// dtype: 0 = float32, 1 = bfloat16. tile_w: columns per weight tile.
extern "C" int block_matmul(const void* x, const void* w, void* out, int M,
                            int N, int K, int tile_w, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rt::launch_tiled_gemm(static_cast<const float*>(x),
                                 static_cast<const float*>(w),
                                 static_cast<float*>(out), M, N, K, tile_w,
                                 bm::Identity{}, s);
  if (dtype == 1)
    return rt::launch_tiled_gemm(static_cast<const __nv_bfloat16*>(x),
                                 static_cast<const __nv_bfloat16*>(w),
                                 static_cast<__nv_bfloat16*>(out), M, N, K,
                                 tile_w, bm::Identity{}, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
