// block_matmul: x[M,K] @ w[K,N] over the weight's column-tile relation.
//
// Replaces the TPU kernel src/repro/kernels/block_matmul/kernel.py
// (block_matmul_pallas), the fused realization of rule R3-1's
// tensor-relational matmul.
//
// Bound on the H100: operations on the tensor cores. At the main path's
// shape (1320 x 4096 @ 4096 x 2048) the product does 22 GFLOP against 66 MB
// of traffic, far above the card's FLOP-per-byte balance. f32 keeps the
// 1e-4 bar by the three-way TF32 split of tc_gemm.cuh (3 TF32 products per
// f32 product), so the least time is 3 x 2MNK at the TF32 tensor-core rate.
// The design feeds wgmma from a ring of cp.async stages of 64 x 128 x 32
// tiles, splits each operand once (w^T in registers, x's slice in shared
// memory), sums each K slice apart so the tensor cores' rounding does not
// drift, and cuts each weight tile of the relation into 128-wide column
// blocks (tc_gemm.cuh).
#include "tc_gemm.cuh"

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
    return rt::launch_tc_gemm(static_cast<const float*>(x),
                              static_cast<const float*>(w),
                              static_cast<float*>(out), M, N, K, tile_w,
                              bm::Identity{}, s);
  if (dtype == 1)
    return rt::launch_tc_gemm(static_cast<const __nv_bfloat16*>(x),
                              static_cast<const __nv_bfloat16*>(w),
                              static_cast<__nv_bfloat16*>(out), M, N, K,
                              tile_w, bm::Identity{}, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
