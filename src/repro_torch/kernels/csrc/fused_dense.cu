// fused_dense: act(x[M,K] @ w[K,N] + b[N]) in one pass.
//
// Replaces the TPU kernel src/repro/kernels/fused_dense/kernel.py
// (fused_dense_pallas, activation _apply_act), the operator that rule
// R4-1-fuse creates from a matmul -> bias -> act chain.
//
// Bound on the H100: operations for the main path's layers (K and N of 256
// give 3 x 2MNK TF32 tensor-core operations in f32, by tc_gemm.cuh's
// three-way split, against 4 bytes per element of x and of out), bytes for
// thin layers. The design shares block_matmul's tensor-core core (wgmma fed
// by a ring of cp.async stages; the blocks over one slice of x rows run
// together, so x is read from device memory about once) and applies bias
// and activation to the accumulator fragments in registers before the
// single store, so the pre-activation never makes a round trip through
// device memory.
#include "tc_gemm.cuh"

namespace fd {

// activation codes, in the order of the wrapper's table
enum Act { kIdentity = 0, kRelu = 1, kSigmoid = 2, kTanh = 3, kGelu = 4,
           kSquaredRelu = 5 };

__device__ __forceinline__ float apply_act(int act, float v) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.f);
    case kSigmoid: return 1.f / (1.f + expf(-v));
    case kTanh: return tanhf(v);
    case kGelu: {  // tanh form, jax.nn.gelu's default constants
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
    case kSquaredRelu: { const float r = fmaxf(v, 0.f); return r * r; }
    default: return v;
  }
}

template <typename T>
struct BiasAct {
  const T* b;
  int act;
  __device__ __forceinline__ float operator()(float acc, int col) const {
    return apply_act(act, acc + rt::to_f32(b[col]));
  }
};

}  // namespace fd

// dtype: 0 = float32, 1 = bfloat16. act: see enum Act.
extern "C" int fused_dense(const void* x, const void* w, const void* b,
                           void* out, int M, int N, int K, int act, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act < fd::kIdentity || act > fd::kSquaredRelu)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return rt::launch_tc_gemm(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), M, N, K, N,
        fd::BiasAct<float>{static_cast<const float*>(b), act}, s);
  if (dtype == 1)
    return rt::launch_tc_gemm(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
        M, N, K, N,
        fd::BiasAct<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(b), act}, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
