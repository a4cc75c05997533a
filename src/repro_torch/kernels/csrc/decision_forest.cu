// decision_forest: mean over T complete depth-D trees of the leaf value
// each row reaches; node <- 2*node + 1 + [x[feat[node]] > thresh[node]]
// (strict > in f32, feat clamped to [0, d-1] as JAX's gathers clamp),
// leaf = node - (2^D - 1).
//
// Replaces the TPU kernel src/repro/kernels/decision_forest/kernel.py
// (forest_pallas), the fused realization of rule R3-2 and the `forest` atom
// on backend `kernel`. The TPU kernel turned the gathers into one-hot
// matmuls for its matrix unit; here every thread walks its rows with direct
// gathers (a TF32 one-hot product would round x and flip the > tests).
//
// What bounds it on the H100. By the roofline, bytes: each row's features
// are read once, a handful of compares per byte (0.0105 ms at the main
// path's 289,000 x 29 rows, 100 trees of depth 9). But a walk is D
// dependent lookups, and each is a shared-memory request: the row value and
// the node record, at best one and two wavefronts a warp step, and an SM
// serves one wavefront a clock. That request rate, n*T*D lookups over 32
// lanes x 3 wavefronts, is the floor this design can reach (chip_smoke.py
// prints it beside the bound). The first port read the rows from global
// memory, one row a lane: 32 L1 wavefronts a gather, spilling to L2.
//
// The design (tiling from ops.py::forest_tiling):
// - Rows in shared memory, feature-major: a block's BM rows (BM a multiple
//   of 32) land by 4-byte cp.async at s_x[f*BM + r], lane by row, so the
//   transpose happens in the copy. Lane r of a warp then reads bank r mod 32
//   whatever feature it wants: every row gather of the walk is one
//   conflict-free wavefront. Where 32 rows of d features do not fit beside
//   one tree, the STAGE_X = false instance reads x from global memory.
// - Trees in chunks of packed 8-byte node records {clamped feat as the byte
//   offset of its run in s_x, thresh} with the chunk's leaves beside them:
//   one shared load a level. feat and thresh land by 4-byte cp.async in the
//   two halves of the records, and one pass over the landed chunk clamps
//   feat and scales it to its offset. Two buffers when the forest does not
//   fit whole: chunk c+1 loads while chunk c is walked, two barriers per
//   chunk.
// - Several walks in flight per thread: ROWS rows x TREES trees, stepped
//   level by level together (all record loads, then all row loads), so
//   their chains of dependent loads overlap.
// - Blocks of 256 threads. Below 256 rows (few rows, or wide ones) the
//   warps split the block's trees in tsplit groups instead of idling, and
//   add their sums at the end.
// - Leaves are summed per row in tree order in f32 (per group, then the
//   groups in order) with no atomics: the same result on every run.
#include <cuda_runtime.h>
#include <stddef.h>

#include "wgmma.cuh"

namespace df {

constexpr int kMaxThreads = 256;

// NT trees, `step` trees apart in the chunk (records rec + t*step*n_int,
// leaves lv + t*step*n_leaf), walked for the thread's ROWS rows at once;
// leaf values added to acc in tree order. A walk keeps its node as the byte
// offset of the node's record (8 * node), and a record's feature as the byte
// offset of the feature's run in x, so each level is one add per address.
// xo: the rows' byte offsets within a feature's run (staged rows); xg: the
// rows in global memory.
template <int NT, int ROWS, bool STAGE_X>
__device__ __forceinline__ void walk(const int2* rec, const float* lv, int step,
                                     int n_int, int n_leaf, int depth,
                                     const float* s_x, const int* xo,
                                     const float* const* xg, float* acc) {
  const char* rb[NT];
  int off[NT][ROWS];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    rb[t] = reinterpret_cast<const char*>(rec + t * step * n_int);
#pragma unroll
    for (int j = 0; j < ROWS; ++j) off[t][j] = 0;
  }
  const char* xs = reinterpret_cast<const char*>(s_x);
  // each level issues all NT x ROWS record loads, then all row loads, then
  // the compares, so that the walks' loads are in flight together
  for (int l = 0; l < depth; ++l) {
    int2 r[NT][ROWS];
    float v[NT][ROWS];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        r[t][j] = *reinterpret_cast<const int2*>(rb[t] + off[t][j]);
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        if constexpr (STAGE_X)
          v[t][j] = *reinterpret_cast<const float*>(xs + r[t][j].x + xo[j]);
        else
          v[t][j] = __ldg(reinterpret_cast<const float*>(
              reinterpret_cast<const char*>(xg[j]) + r[t][j].x));
      }
    // node <- 2*node + 1 + [x > thresh], in bytes
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        off[t][j] = 2 * off[t][j] + (v[t][j] > __int_as_float(r[t][j].y) ? 16 : 8);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
      acc[j] += lv[t * step * n_leaf + (off[t][j] >> 3) - n_int];
}

// (at least one block an SM: with the thread count alone as the bound, ptxas
// spilled a few bytes in three instances at 32-40 registers)
template <int ROWS, int TREES, bool STAGE_X>
__global__ void __launch_bounds__(kMaxThreads, 1)
forest_kernel(const float* __restrict__ x, const int* __restrict__ feat,
              const float* __restrict__ thresh, const float* __restrict__ leaf,
              float* __restrict__ out, int n, int d, int n_trees, int depth,
              int chunk, int stages, int split) {
  extern __shared__ __align__(16) unsigned char smem[];
  // tsplit groups of warps share the block's rows and split its trees: the
  // thread walks rows rt + j * row_threads of trees tg, tg + tsplit, ...
  // Only the one-row, two-tree instance splits; in the others tsplit is 1
  // at compile time.
  constexpr bool SPLIT = ROWS == 1 && TREES == 2;
  const int tsplit = SPLIT ? split : 1;
  const int threads = blockDim.x, tid = threadIdx.x;
  const int row_threads = threads / tsplit, rt = tid % row_threads, tg = tid / row_threads;
  const int bm = row_threads * ROWS, row0 = blockIdx.x * bm;
  const int n_int = (1 << depth) - 1, n_leaf = 1 << depth;
  float* s_x = reinterpret_cast<float*>(smem);
  unsigned char* s_tree = smem + (STAGE_X ? (size_t)bm * d * 4 : 0);
  const size_t rec_bytes = (size_t)chunk * n_int * 8;
  const size_t buf_bytes = rec_bytes + (size_t)chunk * n_leaf * 4;
  const int n_chunks = (n_trees + chunk - 1) / chunk;

  auto records = [&](int c) {
    return reinterpret_cast<int2*>(s_tree + (size_t)(c % stages) * buf_bytes);
  };
  auto leaves = [&](int c) {
    return reinterpret_cast<float*>(s_tree + (size_t)(c % stages) * buf_bytes + rec_bytes);
  };
  // chunk c's feat and thresh into the halves of its records, its leaves beside
  auto issue = [&](int c) {
    int2* rec = records(c);
    float* lv = leaves(c);
    const int t0 = c * chunk, count = min(chunk, n_trees - t0);
    const int* f = feat + (size_t)t0 * n_int;
    const float* th = thresh + (size_t)t0 * n_int;
    for (int i = tid; i < count * n_int; i += threads) {
      hop::cp_async4(hop::smem_u32(&rec[i].x), f + i, true);
      hop::cp_async4(hop::smem_u32(&rec[i].y), th + i, true);
    }
    const float* l = leaf + (size_t)t0 * n_leaf;
    for (int i = tid; i < count * n_leaf; i += threads)
      hop::cp_async4(hop::smem_u32(lv + i), l + i, true);
  };

  if (n_chunks > 0) issue(0);
  // the thread's rows: r = rt + j * row_threads, their features tg, tg +
  // tsplit, ... copied by this thread; rows past n are zero-filled (staged)
  // or walk the last row (global), and their result is not stored
  int xo[ROWS];
  const float* xg[ROWS];
  float acc[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int r = rt + j * row_threads;
    const bool ok = row0 + r < n;
    xo[j] = r * 4;
    xg[j] = x + (size_t)min(row0 + r, n - 1) * d;
    acc[j] = 0.f;
    if constexpr (STAGE_X) {
      for (int f = tg; f < d; f += tsplit)
        hop::cp_async4(hop::smem_u32(s_x + (size_t)f * bm + r), xg[j] + f, ok);
    }
  }
  hop::cp_async_commit();

  // bytes from one feature to the next in the x the walk reads
  const int stride = STAGE_X ? bm * 4 : 4;
  for (int c = 0; c < n_chunks; ++c) {
    hop::cp_async_wait<0>();
    __syncthreads();  // chunk c (and the rows) landed; chunk c-1's walks done
    int2* rec = records(c);
    const float* lv = leaves(c);
    const int count = min(chunk, n_trees - c * chunk);
    for (int i = tid; i < count * n_int; i += threads)
      rec[i].x = min(max(rec[i].x, 0), d - 1) * stride;
    __syncthreads();
    if (stages == 2 && c + 1 < n_chunks) {
      issue(c + 1);
      hop::cp_async_commit();
    }
    int k = tg;
    for (; k + (TREES - 1) * tsplit < count; k += TREES * tsplit)
      walk<TREES, ROWS, STAGE_X>(rec + k * n_int, lv + k * n_leaf, tsplit, n_int,
                                 n_leaf, depth, s_x, xo, xg, acc);
    for (; k < count; k += tsplit)
      walk<1, ROWS, STAGE_X>(rec + k * n_int, lv + k * n_leaf, tsplit, n_int, n_leaf,
                             depth, s_x, xo, xg, acc);
    if (stages == 1 && c + 1 < n_chunks) {
      __syncthreads();  // every walk of chunk c is done before its buffer refills
      issue(c + 1);
      hop::cp_async_commit();
    }
  }
  hop::cp_async_wait<0>();
  if (SPLIT && tsplit > 1) {  // the groups' sums, added in group order
    __syncthreads();  // every walk is done: the tree buffers hold the partials
    float* part = reinterpret_cast<float*>(s_tree);
#pragma unroll
    for (int j = 0; j < ROWS; ++j) part[tg * bm + rt + j * row_threads] = acc[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      acc[j] = 0.f;
      for (int g = 0; g < tsplit; ++g) acc[j] += part[g * bm + rt + j * row_threads];
    }
  }
  if (tg == 0) {
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int row = row0 + rt + j * row_threads;
      if (row < n) out[row] = acc[j] / (float)n_trees;
    }
  }
}

template <int ROWS, int TREES, bool STAGE_X>
int launch(const float* x, const int* feat, const float* thresh, const float* leaf,
           float* out, int n, int d, int n_trees, int depth, int threads, int chunk,
           int stages, int tsplit, size_t smem, cudaStream_t stream) {
  auto kernel = forest_kernel<ROWS, TREES, STAGE_X>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int bm = threads / tsplit * ROWS;
  kernel<<<(n + bm - 1) / bm, threads, smem, stream>>>(
      x, feat, thresh, leaf, out, n, d, n_trees, depth, chunk, stages, tsplit);
  return static_cast<int>(cudaGetLastError());
}

template <bool STAGE_X>
int dispatch(int rows, int walk_trees, const float* x, const int* feat,
             const float* thresh, const float* leaf, float* out, int n, int d,
             int n_trees, int depth, int threads, int chunk, int stages, int tsplit,
             size_t smem, cudaStream_t s) {
#define DF_INSTANCE(R, T)                                                         \
  if (rows == R && walk_trees == T)                                               \
    return launch<R, T, STAGE_X>(x, feat, thresh, leaf, out, n, d, n_trees, depth, \
                                 threads, chunk, stages, tsplit, smem, s);
  DF_INSTANCE(1, 2)
  DF_INSTANCE(1, 4)
  DF_INSTANCE(2, 2)
  DF_INSTANCE(3, 2)
  DF_INSTANCE(4, 2)
#undef DF_INSTANCE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace df

extern "C" int forest_predict(const void* x, const void* feat, const void* thresh,
                              const void* leaf, void* out, int n, int d, int n_trees,
                              int depth, int threads, int rows, int walk_trees,
                              int chunk, int stages, int tsplit, int stage_x, int smem,
                              void* stream) {
  if (threads < 32 || threads > df::kMaxThreads || tsplit < 1 || threads % (32 * tsplit)
      || (tsplit > 1 && (rows != 1 || walk_trees != 2)) || chunk < 1
      || (stages != 1 && stages != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  auto xp = static_cast<const float*>(x);
  auto fp = static_cast<const int*>(feat);
  auto tp = static_cast<const float*>(thresh);
  auto lp = static_cast<const float*>(leaf);
  auto op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return stage_x ? df::dispatch<true>(rows, walk_trees, xp, fp, tp, lp, op, n, d,
                                      n_trees, depth, threads, chunk, stages, tsplit,
                                      (size_t)smem, s)
                 : df::dispatch<false>(rows, walk_trees, xp, fp, tp, lp, op, n, d,
                                       n_trees, depth, threads, chunk, stages, tsplit,
                                       (size_t)smem, s);
}
