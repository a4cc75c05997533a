// flash_attention_bwd: the gradient of flash_attention (flash_attention.cu)
// at its output cotangent dO, FlashAttention-2's equations:
//   P  = exp(S * scale - lse)   S = q k^T, recomputed from the forward's lse,
//                               zero where the forward masked (j >= Skv and,
//                               if causal, the top-left mask i < j);
//   Dr = rowsum(dO * o);
//   dV = P^T dO;   dS = P * (dO V^T - Dr);   dQ = dS K * scale;
//   dK = dS^T Q * scale;
// a KV head's dK and dV sum over the G query heads of its group.
//
// Replaces no TPU kernel: the Pallas flash_attention has no custom_vjp, and
// the JAX package trains through the autodiff of its jnp twin,
// src/repro/models/layers.py::jnp_flash_attention. The port's forward runs
// the kernel, which autograd cannot differentiate, so training needs this
// backward (ops.py FlashAttentionFn).
//
// Bound on the H100: operations. The five products cost 2 (3 D + 2 Dv)
// operations a (row, key) pair the mask keeps (ops.bwd_flops): at the LM's
// training shape (B 4, S 2048, 32 query heads over 8 KV heads, D 64,
// causal, bf16) 171.9 GFLOP, 0.174 ms at the 989 TFLOP/s of the bf16
// tensor cores, against 67 MB of operands and gradients (0.02 ms at 3.35
// TB/s). What keeps a kernel from that rate is how much of its time the
// tensor cores are fed: every product waits on the one before it, a
// softmax of ex2 on every element sits between them, and each streamed
// tile costs a barrier and a load.
//
// Kernels, launched in order on the caller's stream by the C entry:
//   bwd_preprocess  Dr = rowsum(dO * o), float32 [B*Hq, Sq]; a row's values
//                   in 16-byte pieces (bf16) over a few threads;
//   dK/dV           one block per (b, KV head, key tile): K and V of the tile
//                   stay in shared memory while the block walks the group's
//                   query heads and, per head, the Q tiles the causal mask
//                   does not skip; dK and dV accumulate in registers;
//   dQ              one block per (b, query head, row tile), walking the KV
//                   tiles up to the causal diagonal; dQ in registers.
// Every output element is written once by one thread and every sum runs in
// a fixed order: no atomics, so two calls give the same bits. The split
// costs two products (S and dP are computed in both kernels: seven where
// five suffice); what it buys is that determinism without ordering the
// blocks' adds into a shared dQ.
//
// bf16 (fab::tc): wgmma, every pair on the tensor cores. 256-thread blocks
// of two warpgroups, each owning 64 rows of the block's 128 (keys in dK/dV,
// query rows in dQ): a streamed tile feeds 128 keys or rows. The block's own
// tile is copied once into shared memory; the streamed tiles (Q and dO rows
// with their lse and Dr in dK/dV; keys of K and V in dQ) arrive by cp.async
// 16-byte copies into a ring of two stages, so tile t+1 is in flight while
// tile t is computed. A streamed tile has 128 rows where the accumulators
// fit the registers (dK/dV at D + Dv <= 128, dQ at D and Dv <= 128: S and
// dP are then m64n128 products, and each wait and barrier covers twice the
// work), else 64. Tiles are stored in the swizzled layouts wgmma reads
// (wgmma.cuh), in atoms of 64 columns (D >= 64; 32 or 16 below), and each
// is read both ways: K-major where it is the reduced side of a product,
// MN-major (transpose bit) where it is the B of one. Per streamed tile and
// warpgroup:
//   dK/dV: S^T = K Q^T, then dP^T = V dO^T issued behind it (both operands
//          K-major from shared memory); P^T = exp2(S^T scale log2(e) - lse
//          log2(e)) on the accumulator fragments while dP^T runs, rounded
//          to bf16 in place: the f32 accumulator layout is the A fragment
//          of the next product, so P never goes through shared memory; dV
//          += P^T dO (A from registers, B = dO MN-major) runs while dS^T =
//          P^T (dP^T - Dr) is formed the same way (from P as rounded for
//          dV); then dK += dS^T Q. P and dS are rounded to bf16 for their
//          products, as the forward's P is for P V.
//   dQ:    S = Q K^T, then dP = dO V^T behind it; P while dP runs; dS =
//          P (dP - Dr); dQ += dS K (K MN-major).
// The first k-step of S and dP only writes its accumulators, so they are
// not live across the loop. Only tiles on the causal diagonal or past Sq or
// Skv are masked; the others run one FFMA and one ex2 an element. At D >
// 128 dK, dV, S^T and dP^T together would exceed the 255 registers a
// thread has, so dK/dV runs as two passes (dV: S^T and P^T dO; dK: S^T,
// dP^T and dS^T Q), eight products where seven run below. ptxas reports
// no spill in any instance (chip_smoke.py [build]).
//
// float32 (fab::simt, CUDA cores): one 256-thread block, 64x64 register
// tiles (thread (ty, tx) owns rows ty + 16 i and columns tx + 16 c), P^T and
// dS^T through shared memory; all products float32 FMA (no TF32), so the
// f32 path meets the 2e-4 bar.
//
// Both: the gradients are rounded to the operands' type once, at the
// store. Strides over B, H and S are arguments for every operand and output
// (unit stride on D), so the model's transposed [B, S, H, D] views are read
// and written in place, dK and dV in the layout of the K and V the caller
// passes. Blocks of the causal dK/dV walk start from the first key tile and
// those of dQ from the last row tile: the longest first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace fab {

struct Strides { long long b, h, s; };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B*Hq, Sq]
  float* dr;         // [B*Hq, Sq]
  void* dq;
  void* dk;
  void* dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int hq, hkv, group, sq, skv, causal;
  float scale;
};

constexpr int PRE_THREADS = 256;

// Dr's reads: bf16 rows in 16-byte pieces of 8 values (the wrapper holds
// them to 16-byte rows), f32 rows a value at a time (they need not be);
// RT threads, a power of two up to 32, share a row
template <typename T, int DV>
struct Pre {
  static constexpr int VEC = sizeof(T) == 2 ? 8 : 1, PIECES = DV / VEC;
  static constexpr int RT = PIECES >= 32 ? 32 : PIECES >= 16 ? 16 : PIECES >= 8 ? 8
                            : PIECES >= 4 ? 4 : 2;
  static constexpr int ROWS = PRE_THREADS / RT;  // rows a block
};

template <typename T, int DV>
__global__ void __launch_bounds__(PRE_THREADS) bwd_preprocess(Params p) {
  using P = Pre<T, DV>;
  const int bh = blockIdx.x, b = bh / p.hq, h = bh % p.hq;
  const int row = blockIdx.y * P::ROWS + threadIdx.x / P::RT, t = threadIdx.x % P::RT;
  float acc = 0.f;
  if (row < p.sq) {
    const T* o = static_cast<const T*>(p.o) + b * p.os.b + h * p.os.h + row * p.os.s;
    const T* d = static_cast<const T*>(p.dout) + b * p.dos.b + h * p.dos.h + row * p.dos.s;
    for (int c = t; c < P::PIECES; c += P::RT) {
      if constexpr (P::VEC == 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + 8 * c);
        const uint4 dv = *reinterpret_cast<const uint4*>(d + 8 * c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 x = __bfloat1622float2(o2[k]), y = __bfloat1622float2(d2[k]);
          acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
        }
      } else {
        acc = fmaf(static_cast<float>(o[c]), static_cast<float>(d[c]), acc);
      }
    }
  }
#pragma unroll
  for (int off = P::RT / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < p.sq && t == 0) p.dr[(long long)bh * p.sq + row] = acc;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BQ = 64, BKV = 64, THREADS = 256;

// rows [row0, row0 + n) of a [rows, W] matrix (row stride `stride`) into
// shared memory as [n][W + 1]; rows at or past `limit` are zero
template <int W>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long stride,
                                          int row0, int n, int limit) {
  for (int i = threadIdx.x; i < n * W; i += THREADS) {
    const int r = i / W, c = i % W, row = row0 + r;
    dst[r * (W + 1) + c] = row < limit ? src[row * stride + c] : 0.f;
  }
}

// rows [row0, row0 + BQ) of one head's lse and Dr into shared memory
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dr_s, const float* lse,
                                               const float* dr, int row0, int limit) {
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    const int row = row0 + i;
    lse_s[i] = row < limit ? lse[row] : 0.f;
    dr_s[i] = row < limit ? dr[row] : 0.f;
  }
}

template <int D, int DV>
constexpr int dkdv_floats() {
  return BKV * (D + 1) + BKV * (DV + 1) + BQ * (D + 1) + BQ * (DV + 1) +
         2 * BKV * (BQ + 1) + 2 * BQ;
}

template <int D, int DV>
constexpr int dq_floats() {
  return BQ * (D + 1) + BQ * (DV + 1) + BKV * (D + 1) + BKV * (DV + 1) +
         BQ * (BKV + 1) + 2 * BQ;
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS) bwd_dkdv(Params p) {
  constexpr int LD = D + 1, LV = DV + 1, LP = BQ + 1, DC = D / 16, VC = DV / 16;
  extern __shared__ float smem[];
  float* Ks = smem;               // [BKV][LD]
  float* Vs = Ks + BKV * LD;      // [BKV][LV]
  float* Qs = Vs + BKV * LV;      // [BQ][LD]
  float* dOs = Qs + BQ * LD;      // [BQ][LV]
  float* Ps = dOs + BQ * LV;      // [BKV][LP]: P^T
  float* dSs = Ps + BKV * LP;     // [BKV][LP]: dS^T
  float* lse_s = dSs + BKV * LP;  // [BQ]
  float* dr_s = lse_s + BQ;       // [BQ]

  const int bk = blockIdx.x, b = bk / p.hkv, hk = bk % p.hkv;
  const int kv0 = blockIdx.y * BKV;  // the longest causal tiles come first
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  load_rows<D>(Ks, static_cast<const float*>(p.k) + b * p.ks.b + hk * p.ks.h, p.ks.s, kv0,
               BKV, p.skv);
  load_rows<DV>(Vs, static_cast<const float*>(p.v) + b * p.vs.b + hk * p.vs.h, p.vs.s, kv0,
                BKV, p.skv);

  float dk[4][DC], dv[4][VC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < VC; ++c) dv[i][c] = 0.f;
  }

  const int n_q = (p.sq + BQ - 1) / BQ;
  const int t0 = p.causal ? kv0 / BQ : 0;  // Q tiles wholly above the diagonal skipped
  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    const float* q = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h;
    const float* dout = static_cast<const float*>(p.dout) + b * p.dos.b + h * p.dos.h;
    const long long row_base = ((long long)b * p.hq + h) * p.sq;
    for (int t = t0; t < n_q; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // the last tile's readers are done
      load_rows<D>(Qs, q, p.qs.s, q0, BQ, p.sq);
      load_rows<DV>(dOs, dout, p.dos.s, q0, BQ, p.sq);
      load_row_stats(lse_s, dr_s, p.lse + row_base, p.dr + row_base, q0, p.sq);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: keys ty + 16 i, queries tx + 16 j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float a[4], bq[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Ks[(ty + 16 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bq[j] = Qs[(tx + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bq[j], s[i][j]);
      }
#pragma unroll 8
      for (int e = 0; e < DV; ++e) {
        float a[4], bo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Vs[(ty + 16 * i) * LV + e];
#pragma unroll
        for (int j = 0; j < 4; ++j) bo[j] = dOs[(tx + 16 * j) * LV + e];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a[i], bo[j], dp[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = kv0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j, row = q0 + r;
          const bool ok = row < p.sq && col < p.skv && (!p.causal || row >= col);
          const float pv = ok ? expf(s[i][j] * p.scale - lse_s[r]) : 0.f;
          Ps[(ty + 16 * i) * LP + r] = pv;
          dSs[(ty + 16 * i) * LP + r] = pv * (dp[i][j] - dr_s[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q
#pragma unroll 4
      for (int c = 0; c < BQ; ++c) {
        float pp[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pp[i] = Ps[(ty + 16 * i) * LP + c];
          ds[i] = dSs[(ty + 16 * i) * LP + c];
        }
#pragma unroll
        for (int cc = 0; cc < VC; ++cc) {
          const float ov = dOs[c * LV + tx + 16 * cc];
#pragma unroll
          for (int i = 0; i < 4; ++i) dv[i][cc] = fmaf(pp[i], ov, dv[i][cc]);
        }
#pragma unroll
        for (int cd = 0; cd < DC; ++cd) {
          const float qv = Qs[c * LD + tx + 16 * cd];
#pragma unroll
          for (int i = 0; i < 4; ++i) dk[i][cd] = fmaf(ds[i], qv, dk[i][cd]);
        }
      }
    }
  }

  float* dk_out = static_cast<float*>(p.dk) + b * p.dks.b + hk * p.dks.h;
  float* dv_out = static_cast<float*>(p.dv) + b * p.dvs.b + hk * p.dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = kv0 + ty + 16 * i;
    if (row >= p.skv) continue;
#pragma unroll
    for (int cd = 0; cd < DC; ++cd) dk_out[row * p.dks.s + tx + 16 * cd] = dk[i][cd] * p.scale;
#pragma unroll
    for (int cc = 0; cc < VC; ++cc) dv_out[row * p.dvs.s + tx + 16 * cc] = dv[i][cc];
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS) bwd_dq(Params p) {
  constexpr int LD = D + 1, LV = DV + 1, LP = BKV + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][LD]
  float* dOs = Qs + BQ * LD;      // [BQ][LV]
  float* Ks = dOs + BQ * LV;      // [BKV][LD]
  float* Vs = Ks + BKV * LD;      // [BKV][LV]
  float* dSs = Vs + BKV * LV;     // [BQ][LP]
  float* lse_s = dSs + BQ * LP;   // [BQ]
  float* dr_s = lse_s + BQ;       // [BQ]

  const int tile = gridDim.y - 1 - blockIdx.y;  // the longest causal tiles first
  const int bh = blockIdx.x, b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  const int q0 = tile * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* k = static_cast<const float*>(p.k) + b * p.ks.b + hk * p.ks.h;
  const float* v = static_cast<const float*>(p.v) + b * p.vs.b + hk * p.vs.h;
  load_rows<D>(Qs, static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h, p.qs.s, q0, BQ,
               p.sq);
  load_rows<DV>(dOs, static_cast<const float*>(p.dout) + b * p.dos.b + h * p.dos.h, p.dos.s,
                q0, BQ, p.sq);
  const long long row_base = (long long)bh * p.sq;
  load_row_stats(lse_s, dr_s, p.lse + row_base, p.dr + row_base, q0, p.sq);

  float dq[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;

  int n_kv = (p.skv + BKV - 1) / BKV;
  if (p.causal) n_kv = min(n_kv, (min(q0 + BQ, p.sq) - 1) / BKV + 1);
  for (int j = 0; j < n_kv; ++j) {
    const int kv0 = j * BKV;
    __syncthreads();  // the last tile's readers are done
    load_rows<D>(Ks, k, p.ks.s, kv0, BKV, p.skv);
    load_rows<DV>(Vs, v, p.vs.s, kv0, BKV, p.skv);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: queries ty + 16 i, keys tx + 16 jj
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bk[jj] = Ks[(tx + 16 * jj) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(a[i], bk[jj], s[i][jj]);
    }
#pragma unroll 8
    for (int e = 0; e < DV; ++e) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dOs[(ty + 16 * i) * LV + e];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bv[jj] = Vs[(tx + 16 * jj) * LV + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) dp[i][jj] = fmaf(a[i], bv[jj], dp[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = kv0 + tx + 16 * jj;
        const bool ok = row < p.sq && col < p.skv && (!p.causal || row >= col);
        const float pv = ok ? expf(s[i][jj] * p.scale - lse_s[r]) : 0.f;
        dSs[r * LP + tx + 16 * jj] = pv * (dp[i][jj] - dr_s[r]);
      }
    }
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int cd = 0; cd < DC; ++cd) {
        const float kv = Ks[c * LD + tx + 16 * cd];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][cd] = fmaf(ds[i], kv, dq[i][cd]);
      }
    }
  }

  float* dq_out = static_cast<float*>(p.dq) + b * p.dqs.b + h * p.dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
#pragma unroll
    for (int cd = 0; cd < DC; ++cd) dq_out[row * p.dqs.s + tx + 16 * cd] = dq[i][cd] * p.scale;
  }
}

template <int D, int DV>
cudaError_t run(const Params& p, int batch, cudaStream_t stream) {
  constexpr int dkdv_bytes = dkdv_floats<D, DV>() * 4, dq_bytes = dq_floats<D, DV>() * 4;
  static bool configured = false;  // the attributes are set once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dkdv<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(bwd_dq<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  bwd_dkdv<D, DV><<<dim3(batch * p.hkv, (p.skv + BKV - 1) / BKV), THREADS, dkdv_bytes,
                    stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq<D, DV><<<dim3(batch * p.hq, (p.sq + BQ - 1) / BQ), THREADS, dq_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WGS = 2, THREADS = 128 * WGS, STAGES = 2;
constexpr int BLOCK = 64 * WGS;  // a block's own rows: keys (dK/dV), query rows (dQ)
constexpr float LOG2E = 1.4426950408889634f, NEG = -1e30f;

// what a dK/dV instance computes: both, or one of the two passes D > 128 takes
enum Mode { BOTH = 0, DV_ONLY = 1, DK_ONLY = 2 };

template <int D, int DV>
constexpr bool two_passes() {
  return D > 128 || DV > 128;
}

// rows of a streamed tile (query rows in dK/dV, keys in dQ): 128 where the
// products' accumulators fit the registers beside it (S and dP then take
// m64n128 products, twice the work per wait and barrier of 64), else 64.
// dK/dV holds dK, dV, S^T and dP^T; dQ holds dQ, S and dP
template <int D, int DV>
constexpr int dkdv_rows() {
  return D + DV <= 128 ? 128 : 64;
}
template <int D, int DV>
constexpr int dq_rows() {
  return D <= 128 && DV <= 128 ? 128 : 64;
}

// a tile of rows of W bf16 values, stored as atoms of ACOLS columns
template <int W>
struct Geo {
  static constexpr int ACOLS = W >= 64 ? 64 : W;  // bf16 columns of an atom
  static constexpr int SW = ACOLS * 2;              // bytes per atom row
  static constexpr int CHUNKS = SW / 16;            // 16-byte chunks per atom row
  static constexpr int NATOM = (W + ACOLS - 1) / ACOLS;
  static constexpr int bytes(int rows) { return NATOM * rows * SW; }
  static_assert(W % 16 == 0 && ACOLS % 16 == 0, "head dim");
};

// rows [row0, row0 + ROWS) of a [rows, W] bf16 matrix (row stride `stride`)
// into the atoms at `dst`, rows at or past `limit` zero-filled
template <int W, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, long long stride,
                                          int row0, int limit) {
  using G = Geo<W>;
  constexpr int CPR = W / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, ci = i % CPR, row = row0 + r;
    const bool ok = row < limit;
    hop::cp_async16(dst + (ci / G::CHUNKS) * ROWS * G::SW + hop::swizzle<G::SW>(r, ci % G::CHUNKS),
                    ok ? src + row * stride + ci * 8 : src, ok);
  }
}

// a Q tile's lse, then its Dr (float32, TN each), zero past `limit`
template <int TN>
__device__ __forceinline__ void load_stats(uint32_t dst, const float* lse, const float* dr,
                                           int row0, int limit) {
  for (int i = threadIdx.x; i < 2 * TN; i += THREADS) {
    const int row = row0 + i % TN;
    const float* src = i < TN ? lse : dr;
    const bool ok = row < limit;
    hop::cp_async4(dst + 4 * i, ok ? src + row : src, ok);
  }
}

// S[64 x N] (+)= A[64 x 16] B[16 x N], both K-major from shared memory, as
// wgmma.cuh's wgmma_ss_n64 (which the later k-steps of N = 64 use); the
// first k-step (ss_n64_first, FIRST) has scale_d 0 and write-only
// accumulators, so that S is not live (for the compiler) between one tile's
// last use and the next tile's product
__device__ __forceinline__ void ss_n64_first(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

template <bool FIRST>
__device__ __forceinline__ void ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (FIRST)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
          "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
          "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
          "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
          "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
          "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
          "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
          "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
          "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
          "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
          "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
          "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
          "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
        : "l"(da), "l"(db), "r"(0));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
}
// acc[64 x N] = A B^T over W columns: A the 64 rows at a_s of a tile of
// AROWS rows, B the N rows of the tile at b_s, both K-major
template <int W, int AROWS, int N>
__device__ __forceinline__ void product_ss(float (&acc)[N / 2], uint32_t a_s, uint32_t b_s) {
  using G = Geo<W>;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const int atom = kk / (G::ACOLS / 16);
    const uint32_t off = (kk % (G::ACOLS / 16)) * 32;  // 16 columns, in bytes
    const uint64_t da = hop::make_desc<G::SW>(a_s + atom * AROWS * G::SW + off, 16);
    const uint64_t db = hop::make_desc<G::SW>(b_s + atom * N * G::SW + off, 16);
    if constexpr (N == 64) {
      if (kk == 0) ss_n64_first(acc, da, db);
      else hop::wgmma_ss_n64<0>(acc, da, db, 1);
    } else {
      if (kk == 0) ss_n128<true>(acc, da, db);
      else ss_n128<false>(acc, da, db);
    }
  }
}

// acc (+)= A B over one atom of B's columns (acc holds W/2 accumulators), B
// the tile of KROWS rows that b_kk points into
template <int W, int A, int KROWS>
__device__ __forceinline__ void rs_atom(float (&acc)[W / 2], const uint32_t* a, uint32_t b_kk) {
  using G = Geo<W>;
  constexpr int N = W - A * G::ACOLS < G::ACOLS ? W - A * G::ACOLS : G::ACOLS;
  const uint64_t db = hop::make_desc<G::SW>(b_kk + A * KROWS * G::SW, 8 * G::SW);
  if constexpr (N == 64) hop::wgmma_rs_n64<A * 32>(acc, a, db);
  else if constexpr (N == 32) hop::wgmma_rs_n32<A * 32>(acc, a, db);
  else hop::wgmma_rs_n16<A * 32>(acc, a, db);
}

// acc[64 x W] += A B: A the 64 x K operand in registers (bf16 pairs; k-step
// kk is a[4 kk .. 4 kk + 3]), B the tile of K rows at b_s read MN-major
// (transpose bit)
template <int W, int K>
__device__ __forceinline__ void product_rs(float (&acc)[W / 2], const uint32_t (&a)[K / 4],
                                           uint32_t b_s) {
  using G = Geo<W>;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t b_kk = b_s + kk * 16 * G::SW;
    rs_atom<W, 0, K>(acc, a + 4 * kk, b_kk);
    if constexpr (G::NATOM > 1) rs_atom<W, 1, K>(acc, a + 4 * kk, b_kk);
    if constexpr (G::NATOM > 2) rs_atom<W, 2, K>(acc, a + 4 * kk, b_kk);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// the accumulator fragment as bf16 pairs: the A operand of the next product
template <int N>
__device__ __forceinline__ void pack(uint32_t (&a)[N / 2], const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = hop::pack_bf16(x[2 * i], x[2 * i + 1]);
}

// the thread's rows ra and ra + 8 of a 64 x W accumulator into a [rows, W]
// bf16 matrix, times `mul`; rows at or past `limit` are not written
template <int W>
__device__ __forceinline__ void store_rows(bf16* dst, long long stride, const float (&acc)[W / 2],
                                           int ra, int limit, float mul) {
  const int quad = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row >= limit) continue;
    bf16* out = dst + row * stride + 2 * quad;
#pragma unroll
    for (int i = 0; i < W / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r] * mul, acc[4 * i + 2 * r + 1] * mul);
  }
}

// shared memory of a dK/dV block: K and (unless DV_ONLY) V of its BLOCK keys,
// then per stage a Q and a dO tile of TN rows, then per stage the tile's lse
// and Dr; every tile offset a multiple of 1024 bytes
template <int D, int DV, int MODE>
struct DkdvSmem {
  static constexpr int TN = dkdv_rows<D, DV>();
  static constexpr int K = Geo<D>::bytes(BLOCK), V = MODE == DV_ONLY ? 0 : Geo<DV>::bytes(BLOCK);
  static constexpr int Q = Geo<D>::bytes(TN), DO = Geo<DV>::bytes(TN);
  static constexpr int STAGE = Q + DO, STATS = 2 * TN * 4;
  static constexpr int TOTAL = 1024 + K + V + STAGES * (STAGE + STATS);  // + alignment
};

template <int D, int DV, int MODE>
__global__ void __launch_bounds__(THREADS, 1) dkdv(Params p) {
  using GK = Geo<D>;
  using GV = Geo<DV>;
  using SM = DkdvSmem<D, DV, MODE>;
  constexpr int TN = SM::TN;
  constexpr bool WANT_DV = MODE != DK_ONLY, WANT_DK = MODE != DV_ONLY;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = k_s + SM::K, ring = v_s + SM::V;
  const uint32_t stats_s = ring + STAGES * SM::STAGE;
  const float* stats = reinterpret_cast<const float*>(smem_raw + (stats_s - raw));

  const int bk = blockIdx.x, b = bk / p.hkv, hk = bk % p.hkv;
  const int kv0 = blockIdx.y * BLOCK;  // the longest causal walks first
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, quad = lane % 4;
  const int kw0 = kv0 + 64 * wg;               // this warpgroup's first key
  const int ka = kw0 + 16 * warp + lane / 4;  // the thread's keys: ka, ka + 8
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qs.b;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.dos.b;

  load_tile<D, BLOCK>(k_s, static_cast<const bf16*>(p.k) + b * p.ks.b + hk * p.ks.h, p.ks.s,
                      kv0, p.skv);
  if constexpr (WANT_DK)
    load_tile<DV, BLOCK>(v_s, static_cast<const bf16*>(p.v) + b * p.vs.b + hk * p.vs.h,
                         p.vs.s, kv0, p.skv);

  // the walk: the group's heads, each over the Q tiles from the first one
  // the causal mask leaves to this block's keys
  const int t0 = p.causal ? kv0 / TN : 0;
  const int nt = max((p.sq + TN - 1) / TN - t0, 0), n_items = p.group * nt;
  auto load_item = [&](int st, int it) {
    const int h = hk * p.group + it / nt, q0 = (t0 + it % nt) * TN;
    const uint32_t qt = ring + st * SM::STAGE;
    load_tile<D, TN>(qt, q + h * p.qs.h, p.qs.s, q0, p.sq);
    load_tile<DV, TN>(qt + SM::Q, dout + h * p.dos.h, p.dos.s, q0, p.sq);
    const long long rows = ((long long)b * p.hq + h) * p.sq;
    load_stats<TN>(stats_s + st * SM::STATS, p.lse + rows, p.dr + rows, q0, p.sq);
  };
  if (n_items > 0) load_item(0, 0);
  hop::cp_async_commit();

  float s[TN / 2], dp[TN / 2], dk[D / 2], dv[DV / 2];
  uint32_t pa[TN / 4], dsa[TN / 4];
  zero(dk);
  zero(dv);
  const float sl2 = p.scale * LOG2E;

  for (int it = 0; it < n_items; ++it) {
    hop::cp_async_wait<0>();  // item it has landed (this thread's copies)
    hop::fence_proxy_async();
    __syncthreads();  // ... everyone's; and item it-1's stage is free again
    if (it + 1 < n_items) load_item((it + 1) % STAGES, it + 1);
    hop::cp_async_commit();
    const int q0 = (t0 + it % nt) * TN;
    // uniform per warpgroup: keys past Skv, or a tile wholly above the diagonal
    if (kw0 >= p.skv || (p.causal && q0 + TN - 1 < kw0)) continue;
    const int st = it % STAGES;
    const uint32_t q_t = ring + st * SM::STAGE, do_t = q_t + SM::Q;
    const float* lse_t = stats + st * 2 * TN;
    const float* dr_t = lse_t + TN;

    // S^T = K Q^T, then dP^T = V dO^T in flight while P^T is computed
    hop::wgmma_fence();
    product_ss<D, BLOCK, TN>(s, k_s + 64 * wg * GK::SW, q_t);
    hop::wgmma_commit();
    if constexpr (WANT_DK) {
      product_ss<DV, BLOCK, TN>(dp, v_s + 64 * wg * GV::SW, do_t);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
    } else {
      hop::wgmma_wait<0>();
    }
    hop::fence_regs(s);

    // P^T on the fragments: s[4 i + e] is key ka + 8 (e >> 1), query
    // q0 + 8 i + 2 quad + (e & 1)
    const bool edge = (p.causal && q0 < kw0 + 63) || kw0 + 64 > p.skv || q0 + TN > p.sq;
#pragma unroll
    for (int i = 0; i < TN / 8; ++i) {
      const float2 l = *reinterpret_cast<const float2*>(lse_t + 8 * i + 2 * quad);
      const float l2[2] = {l.x * LOG2E, l.y * LOG2E};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = fmaf(s[4 * i + e], sl2, -l2[e & 1]);
        if (edge) {
          const int key = ka + 8 * (e >> 1), row = q0 + 8 * i + 2 * quad + (e & 1);
          if (key >= p.skv || row >= p.sq || (p.causal && row < key)) x = NEG;
        }
        s[4 * i + e] = hop::exp2_approx(x);
      }
    }
    pack<TN / 2>(pa, s);
    if constexpr (WANT_DV) {
      hop::wgmma_fence();
      product_rs<DV, TN>(dv, pa, do_t);  // dV += P^T dO
      hop::wgmma_commit();
    }
    if constexpr (WANT_DK) {
      hop::wgmma_wait<WANT_DV ? 1 : 0>();  // dP^T has landed
      hop::fence_regs(dp);
      // dS^T = P^T (dP^T - Dr), P^T as rounded for dV
#pragma unroll
      for (int i = 0; i < TN / 8; ++i) {
        const float2 r = *reinterpret_cast<const float2*>(dr_t + 8 * i + 2 * quad);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 pp =
              *reinterpret_cast<const __nv_bfloat162*>(&pa[2 * i + (e >> 1)]);
          const float pv = e & 1 ? __high2float(pp) : __low2float(pp);
          dp[4 * i + e] = pv * (dp[4 * i + e] - (e & 1 ? r.y : r.x));
        }
      }
      pack<TN / 2>(dsa, dp);
      hop::wgmma_fence();
      product_rs<D, TN>(dk, dsa, q_t);  // dK += dS^T Q
      hop::wgmma_commit();
    }
    hop::wgmma_wait<0>();
    if constexpr (WANT_DV) hop::fence_regs(dv);
    if constexpr (WANT_DK) {
      hop::fence_regs(dk);
      hop::fence_regs(dsa);
    }
    hop::fence_regs(pa);
  }
  hop::cp_async_wait<0>();

  if constexpr (WANT_DK)
    store_rows<D>(static_cast<bf16*>(p.dk) + b * p.dks.b + hk * p.dks.h, p.dks.s, dk, ka, p.skv,
                  p.scale);
  if constexpr (WANT_DV)
    store_rows<DV>(static_cast<bf16*>(p.dv) + b * p.dvs.b + hk * p.dvs.h, p.dvs.s, dv, ka, p.skv,
                   1.f);
}

// shared memory of a dQ block: Q and dO of its BLOCK rows, then per stage a
// K and a V tile of TN keys
template <int D, int DV>
struct DqSmem {
  static constexpr int TN = dq_rows<D, DV>();
  static constexpr int Q = Geo<D>::bytes(BLOCK), DO = Geo<DV>::bytes(BLOCK);
  static constexpr int K = Geo<D>::bytes(TN), V = Geo<DV>::bytes(TN);
  static constexpr int STAGE = K + V;
  static constexpr int TOTAL = 1024 + Q + DO + STAGES * STAGE;  // + alignment
};

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1) dq(Params p) {
  using GK = Geo<D>;
  using GV = Geo<DV>;
  using SM = DqSmem<D, DV>;
  constexpr int TN = SM::TN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (hop::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + SM::Q, ring = do_s + SM::DO;

  const int tile = gridDim.y - 1 - blockIdx.y;  // the longest causal walks first
  const int bh = blockIdx.x, b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  const int q0 = tile * BLOCK;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, quad = lane % 4;
  const int row0 = q0 + 64 * wg;               // this warpgroup's first row
  const int ra = row0 + 16 * warp + lane / 4;  // the thread's rows: ra, ra + 8
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ks.b + hk * p.ks.h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vs.b + hk * p.vs.h;

  const int n_all = (p.skv + TN - 1) / TN;
  int n_kv = n_all, wg_tiles = row0 < p.sq ? n_all : 0;
  if (p.causal) {
    n_kv = min(n_all, (min(q0 + BLOCK, p.sq) - 1) / TN + 1);
    if (row0 < p.sq) wg_tiles = min(n_all, (min(row0 + 64, p.sq) - 1) / TN + 1);
  }
  auto load_kv = [&](int st, int j) {
    const uint32_t kt = ring + st * SM::STAGE;
    load_tile<D, TN>(kt, k, p.ks.s, j * TN, p.skv);
    load_tile<DV, TN>(kt + SM::K, v, p.vs.s, j * TN, p.skv);
  };
  load_tile<D, BLOCK>(q_s, static_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.h, p.qs.s, q0,
                      p.sq);
  load_tile<DV, BLOCK>(do_s, static_cast<const bf16*>(p.dout) + b * p.dos.b + h * p.dos.h,
                       p.dos.s, q0, p.sq);
  if (n_kv > 0) load_kv(0, 0);
  hop::cp_async_commit();

  // the thread's rows' lse (log2 units) and Dr
  float l2[2], dr[2];
  const long long rows = (long long)bh * p.sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    l2[r] = row < p.sq ? p.lse[rows + row] * LOG2E : 0.f;
    dr[r] = row < p.sq ? p.dr[rows + row] : 0.f;
  }

  float s[TN / 2], dp[TN / 2], dq[D / 2];
  uint32_t dsa[TN / 4];
  zero(dq);
  const float sl2 = p.scale * LOG2E;

  for (int j = 0; j < n_kv; ++j) {
    hop::cp_async_wait<0>();  // tile j has landed (this thread's copies)
    hop::fence_proxy_async();
    __syncthreads();  // ... everyone's; and tile j-1's stage is free again
    if (j + 1 < n_kv) load_kv((j + 1) % STAGES, j + 1);
    hop::cp_async_commit();
    if (j >= wg_tiles) continue;  // uniform per warpgroup
    const uint32_t k_t = ring + (j % STAGES) * SM::STAGE, v_t = k_t + SM::K;

    // S = Q K^T, then dP = dO V^T in flight while P is computed
    hop::wgmma_fence();
    product_ss<D, BLOCK, TN>(s, q_s + 64 * wg * GK::SW, k_t);
    hop::wgmma_commit();
    product_ss<DV, BLOCK, TN>(dp, do_s + 64 * wg * GV::SW, v_t);
    hop::wgmma_commit();
    hop::wgmma_wait<1>();
    hop::fence_regs(s);

    // P on the fragments: s[4 i + e] is row ra + 8 (e >> 1), key
    // c0 + 8 i + 2 quad + (e & 1)
    const int c0 = j * TN;
    const bool edge = c0 + TN > p.skv || (p.causal && c0 + TN - 1 > row0);
#pragma unroll
    for (int i = 0; i < TN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = fmaf(s[4 * i + e], sl2, -l2[e >> 1]);
        if (edge) {
          const int col = c0 + 8 * i + 2 * quad + (e & 1), row = ra + 8 * (e >> 1);
          if (col >= p.skv || (p.causal && row < col)) x = NEG;
        }
        s[4 * i + e] = hop::exp2_approx(x);
      }
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(dp);
    // dS = P (dP - Dr)
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) dp[i] = s[i] * (dp[i] - dr[(i >> 1) & 1]);
    pack<TN / 2>(dsa, dp);

    // dQ += dS K
    hop::wgmma_fence();
    product_rs<D, TN>(dq, dsa, k_t);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dq);
    hop::fence_regs(dsa);
  }
  hop::cp_async_wait<0>();
  store_rows<D>(static_cast<bf16*>(p.dq) + b * p.dqs.b + h * p.dqs.h, p.dqs.s, dq, ra, p.sq,
                p.scale);
}

// sets the instance's shared-memory size once, then launches it
template <typename Kernel>
cudaError_t launch(Kernel kernel, bool& configured, dim3 grid, int bytes, const Params& p,
                   cudaStream_t stream) {
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t run(const Params& p, int batch, cudaStream_t stream) {
  static bool configured[3] = {false, false, false};
  const dim3 kv_grid(batch * p.hkv, (p.skv + BLOCK - 1) / BLOCK);
  const dim3 q_grid(batch * p.hq, (p.sq + BLOCK - 1) / BLOCK);
  cudaError_t err;
  if constexpr (two_passes<D, DV>()) {
    err = launch(dkdv<D, DV, DV_ONLY>, configured[0], kv_grid,
                 DkdvSmem<D, DV, DV_ONLY>::TOTAL, p, stream);
    if (err != cudaSuccess) return err;
    err = launch(dkdv<D, DV, DK_ONLY>, configured[1], kv_grid,
                 DkdvSmem<D, DV, DK_ONLY>::TOTAL, p, stream);
  } else {
    err = launch(dkdv<D, DV, BOTH>, configured[0], kv_grid, DkdvSmem<D, DV, BOTH>::TOTAL, p,
                 stream);
  }
  if (err != cudaSuccess) return err;
  return launch(dq<D, DV>, configured[2], q_grid, DqSmem<D, DV>::TOTAL, p, stream);
}

}  // namespace tc

template <typename T, int D, int DV>
cudaError_t run(const Params& p, int batch, cudaStream_t stream) {
  constexpr int rows = Pre<T, DV>::ROWS;
  bwd_preprocess<T, DV><<<dim3(batch * p.hq, (p.sq + rows - 1) / rows), PRE_THREADS, 0,
                          stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (sizeof(T) == 2)
    return tc::run<D, DV>(p, batch, stream);
  else
    return simt::run<D, DV>(p, batch, stream);
}

// the instantiated (D, DV) pairs: flash_attention.cu's, which ops.py's
// HEAD_DIMS lists
template <typename T>
cudaError_t dispatch(const Params& p, int batch, int d, int dv, cudaStream_t s) {
  if (d == dv) {
    switch (d) {
      case 16: return run<T, 16, 16>(p, batch, s);
      case 32: return run<T, 32, 32>(p, batch, s);
      case 64: return run<T, 64, 64>(p, batch, s);
      case 128: return run<T, 128, 128>(p, batch, s);
      case 160: return run<T, 160, 160>(p, batch, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (d == 192 && dv == 128) return run<T, 192, 128>(p, batch, s);
  if (d == 64 && dv == 32) return run<T, 64, 32>(p, batch, s);
  return cudaErrorInvalidValue;
}

}  // namespace fab

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout and the gradients all
// of it; in bf16 every operand 16-byte aligned with strides a multiple of
// 8). lse and dr: float32 [B*Hq, Sq]; lse the forward's, dr scratch this
// call fills. strides: (b, h, s) in elements for q, k, v, o, dout, dq, dk
// and dv, 24 values; the head dim has unit stride. D is q's and k's head
// dim, Dv v's and o's.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const float* lse,
                                   float* dr, void* dq, void* dk, void* dv, int B, int Hq,
                                   int Hkv, int Sq, int Skv, int D, int Dv, int causal,
                                   int dtype, float scale, const long long* strides,
                                   void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  fab::Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.dr = dr;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  fab::Strides* st[] = {&p.qs, &p.ks, &p.vs, &p.os, &p.dos, &p.dqs, &p.dks, &p.dvs};
  for (int i = 0; i < 8; ++i) *st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.hq = Hq;
  p.hkv = Hkv;
  p.group = Hq / Hkv;
  p.sq = Sq;
  p.skv = Skv;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(fab::dispatch<float>(p, B, D, Dv, s));
  if (dtype == 1) return static_cast<int>(fab::dispatch<__nv_bfloat16>(p, B, D, Dv, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
