// decision_forest: mean over T complete depth-D trees of the leaf value
// each row reaches; node <- 2*node + 1 + [x[feat[node]] > thresh[node]],
// leaf = node - (2^D - 1).
//
// Replaces the TPU kernel src/repro/kernels/decision_forest/kernel.py
// (forest_pallas), the fused realization of rule R3-2 and the `forest` atom
// on backend `kernel`.
//
// Bound on the H100: bytes by the roofline (each row's features are read
// once, a handful of compares per byte), but in practice latency: every
// level is a gather that depends on the previous one. The TPU kernel turned
// the gathers into one-hot matmuls for its matrix unit; here a thread walks
// its row with direct gathers instead (a TF32 one-hot product would round x
// and flip the > tests). One thread per row; per tree the block stages the
// tree's feat / thresh / leaf arrays in shared memory, so the node reads of
// the walk hit shared memory. The feature reads are one row per thread,
// uncoalesced; at the main path's size (289,000 x 29, 100 trees of depth 9)
// they fall through L1 to L2, and the kernel runs far above its bound
// (PERF.md). Staging the block's rows in shared memory is the next step.
// Trees are summed in a fixed order in f32 with no atomics: the result is
// the same on every run.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
forest_kernel(const float* __restrict__ x, const int* __restrict__ feat,
              const float* __restrict__ thresh, const float* __restrict__ leaf,
              float* __restrict__ out, int n, int d, int n_trees, int depth) {
  extern __shared__ float smem[];
  const int n_int = (1 << depth) - 1, n_leaf = 1 << depth;
  int* s_feat = reinterpret_cast<int*>(smem);
  float* s_thresh = smem + n_int;
  float* s_leaf = smem + 2 * n_int;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  // rows past the end walk the last row (their result is not stored) so
  // that every thread reaches each barrier
  const float* xr = x + (size_t)min(row, n - 1) * d;
  float acc = 0.f;
  for (int t = 0; t < n_trees; ++t) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_int; i += blockDim.x) {
      const int f = feat[(size_t)t * n_int + i];
      s_feat[i] = min(max(f, 0), d - 1);
      s_thresh[i] = thresh[(size_t)t * n_int + i];
    }
    for (int i = threadIdx.x; i < n_leaf; i += blockDim.x)
      s_leaf[i] = leaf[(size_t)t * n_leaf + i];
    __syncthreads();
    int node = 0;
    for (int l = 0; l < depth; ++l)
      node = 2 * node + 1 + (__ldg(xr + s_feat[node]) > s_thresh[node]);
    acc += s_leaf[node - n_int];
  }
  if (row < n) out[row] = acc / (float)n_trees;
}

}  // namespace

extern "C" int forest_predict(const void* x, const void* feat,
                              const void* thresh, const void* leaf, void* out,
                              int n, int d, int n_trees, int depth,
                              void* stream) {
  const size_t smem = (size_t)(2 * ((1 << depth) - 1) + (1 << depth)) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        forest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  forest_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(feat),
      static_cast<const float*>(thresh), static_cast<const float*>(leaf),
      static_cast<float*>(out), n, d, n_trees, depth);
  return static_cast<int>(cudaGetLastError());
}
