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
// Bound on the H100: operations. At the LM's training shape (B 4, S 2048,
// 32 query heads over 8 KV heads, D 64, causal, bf16) the backward does
// 2.5x the forward's 68.7 GFLOP, ~171.8 GFLOP: 0.174 ms at the 989
// TFLOP/s of the bf16 tensor cores. This first design does 3.5x the
// forward's products (S and dP are computed twice: once for dK/dV, once
// for dQ, so that no kernel adds into another's output), loads its tiles
// synchronously and runs on mma.sync, not wgmma; a wgmma/TMA design is
// later work.
//
// Three kernels, launched in order on the caller's stream by the C entry:
//   bwd_preprocess  one warp per row: Dr = rowsum(dO * o), float32 [B*Hq, Sq];
//   bwd_dkdv        one block per (b, KV head, 64-key tile): K and V of the
//                   tile stay in shared memory while the block walks the
//                   group's query heads and, per head, the 64-row Q tiles
//                   the causal mask does not skip; dK and dV accumulate in
//                   registers;
//   bwd_dq          one block per (b, query head, 64-row Q tile), walking
//                   the KV tiles up to the causal diagonal; dQ in registers.
// Every output element is written once by one thread and every sum runs in
// a fixed order: no atomics, so two calls give the same bits.
//
// Two instances of the last two kernels:
//
// bf16 with D and DV up to 128 (fab::tc): tensor cores, mma.sync m16n8k16
// with f32 accumulators, 4 warps a block, each owning 16 rows of the
// block's 64-row tile. Tiles are bf16 in shared memory, rows padded to
// W + 8 values so that ldmatrix reads are free of bank conflicts. S^T =
// K Q^T and dP^T = V dO^T take A and B by ldmatrix; P^T and dS^T are
// rounded to bf16 in the accumulator registers, which are the A fragments
// of dV += P^T dO and dK += dS^T Q (B by ldmatrix.trans), as
// FlashAttention-2 does; the dQ kernel does the same with S = Q K^T and
// dQ += dS K. At (128, 128) the dK/dV kernel holds 128 f32 accumulators a
// thread beside its operands.
//
// float32, and bf16 at D 160 and (192, 128) (CUDA cores): one 256-thread
// block, 64x64 register tiles (thread (ty, tx) owns rows ty + 16 i and
// columns tx + 16 c), operands converted to float32 in shared memory, P^T
// and dS^T through shared memory; all products float32 FMA (no TF32), so
// the f32 path meets the 2e-4 bar.
//
// Both: the gradients are rounded to the operands' type once, at the
// store. Strides over B, H and S are arguments for every operand and output
// (unit stride on D), so the model's transposed [B, S, H, D] views are read
// and written in place, dK and dV in the layout of the K and V the caller
// passes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace fab {

constexpr int BQ = 64, BKV = 64, THREADS = 256, ROWS_PER_BLOCK = THREADS / 32;

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [row0, row0 + n) of a [rows, W] matrix (row stride `stride`) into
// shared memory as float32 [n][W + 1]; rows at or past `limit` are zero
template <typename T, int W>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long stride,
                                          int row0, int n, int limit) {
  for (int i = threadIdx.x; i < n * W; i += THREADS) {
    const int r = i / W, c = i % W, row = row0 + r;
    dst[r * (W + 1) + c] = row < limit ? to_f(src[row * stride + c]) : 0.f;
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

template <typename T, int DV>
__global__ void __launch_bounds__(THREADS) bwd_preprocess(Params p) {
  const int bh = blockIdx.x, b = bh / p.hq, h = bh % p.hq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.y * ROWS_PER_BLOCK + warp;
  if (row >= p.sq) return;
  const T* o = static_cast<const T*>(p.o) + b * p.os.b + h * p.os.h + row * p.os.s;
  const T* d = static_cast<const T*>(p.dout) + b * p.dos.b + h * p.dos.h + row * p.dos.s;
  float acc = 0.f;
  for (int c = lane; c < DV; c += 32) acc = fmaf(to_f(o[c]), to_f(d[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.dr[(long long)bh * p.sq + row] = acc;
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

template <typename T, int D, int DV>
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
  load_rows<T, D>(Ks, static_cast<const T*>(p.k) + b * p.ks.b + hk * p.ks.h, p.ks.s,
                  kv0, BKV, p.skv);
  load_rows<T, DV>(Vs, static_cast<const T*>(p.v) + b * p.vs.b + hk * p.vs.h, p.vs.s,
                   kv0, BKV, p.skv);

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
    const T* q = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
    const T* dout = static_cast<const T*>(p.dout) + b * p.dos.b + h * p.dos.h;
    const long long row_base = ((long long)b * p.hq + h) * p.sq;
    for (int t = t0; t < n_q; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // the last tile's readers are done
      load_rows<T, D>(Qs, q, p.qs.s, q0, BQ, p.sq);
      load_rows<T, DV>(dOs, dout, p.dos.s, q0, BQ, p.sq);
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

  T* dk_out = static_cast<T*>(p.dk) + b * p.dks.b + hk * p.dks.h;
  T* dv_out = static_cast<T*>(p.dv) + b * p.dvs.b + hk * p.dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = kv0 + ty + 16 * i;
    if (row >= p.skv) continue;
#pragma unroll
    for (int cd = 0; cd < DC; ++cd)
      dk_out[row * p.dks.s + tx + 16 * cd] = from_f<T>(dk[i][cd] * p.scale);
#pragma unroll
    for (int cc = 0; cc < VC; ++cc)
      dv_out[row * p.dvs.s + tx + 16 * cc] = from_f<T>(dv[i][cc]);
  }
}

template <typename T, int D, int DV>
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
  const T* k = static_cast<const T*>(p.k) + b * p.ks.b + hk * p.ks.h;
  const T* v = static_cast<const T*>(p.v) + b * p.vs.b + hk * p.vs.h;
  load_rows<T, D>(Qs, static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h, p.qs.s,
                  q0, BQ, p.sq);
  load_rows<T, DV>(dOs, static_cast<const T*>(p.dout) + b * p.dos.b + h * p.dos.h,
                   p.dos.s, q0, BQ, p.sq);
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
    load_rows<T, D>(Ks, k, p.ks.s, kv0, BKV, p.skv);
    load_rows<T, DV>(Vs, v, p.vs.s, kv0, BKV, p.skv);
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

  T* dq_out = static_cast<T*>(p.dq) + b * p.dqs.b + h * p.dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
#pragma unroll
    for (int cd = 0; cd < DC; ++cd)
      dq_out[row * p.dqs.s + tx + 16 * cd] = from_f<T>(dq[i][cd] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// bf16 at D, DV <= 128: tensor cores (mma.sync m16n8k16, f32 accumulators)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 4, THREADS = 32 * WARPS;  // each warp owns 16 rows of a 64-row tile

// shared tiles are bf16 rows of W + 8 values: 16-byte rows whose ldmatrix
// reads hit 8 distinct 4-bank groups
template <int W>
constexpr int LD = W + 8;

template <int D, int DV>
constexpr int smem_bytes() {
  return 2 * (BKV * LD<D> + BKV * LD<DV> + BQ * LD<D> + BQ * LD<DV>) + 2 * BQ * 4;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [row0, row0 + n) of a [rows, W] bf16 matrix into shared rows of
// LD<W>, 16 bytes a thread at a time; rows at or past `limit` zero
template <int W>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long stride,
                                          int row0, int n, int limit) {
  constexpr int CPR = W / 8;
  for (int i = threadIdx.x; i < n * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR, row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < limit) val = *reinterpret_cast<const uint4*>(src + row * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD<W> + c * 8) = val;
  }
}

__device__ __forceinline__ void load_stats(float* lse_s, float* dr_s, const float* lse,
                                           const float* dr, int row0, int limit) {
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    const int row = row0 + i;
    lse_s[i] = row < limit ? lse[row] : 0.f;
    dr_s[i] = row < limit ? dr[row] : 0.f;
  }
}

// A fragment: rows row0..row0+15, columns k0..k0+15 of a row-major tile
template <int W>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int row0, int k0,
                                       int lane) {
  hop::ldmatrix_x4(hop::smem_u32(tile + (row0 + lane % 16) * LD<W> + k0 + (lane / 16) * 8), a);
}

// B fragments of two n-tiles (b[0..1]: n0..n0+7, b[2..3]: n0+8..n0+15) over
// k0..k0+15, from a tile stored [n][k] (each row one n)
template <int W>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int n0, int k0,
                                       int lane) {
  hop::ldmatrix_x4(hop::smem_u32(tile + (n0 + lane % 8 + (lane / 16) * 8) * LD<W> + k0 +
                                 ((lane / 8) % 2) * 8), b);
}

// the same from a tile stored [k][n] (each row one k), by ldmatrix.trans
template <int W>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const bf16* tile, int k0, int n0,
                                             int lane) {
  hop::ldmatrix_x4_trans(hop::smem_u32(tile + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * LD<W> +
                                       n0 + (lane / 16) * 8), b);
}

// acc[16 x 64] = A[16 rows of `a_tile` from row0] B^T, B the 64 rows of
// `b_tile` (both [row][K], K = W)
template <int W>
__device__ __forceinline__ void product_nt(float (&acc)[8][4], const bf16* a_tile, int row0,
                                           const bf16* b_tile, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    uint32_t a[4];
    load_a<W>(a, a_tile, row0, 16 * kk, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      load_b<W>(b, b_tile, 16 * np, 16 * kk, lane);
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 x W] += A B, A the 16 x 64 operand in registers (four k-blocks of
// 16), B the 64 rows of `b_tile` ([k][n], n = W)
template <int W>
__device__ __forceinline__ void product_rs(float (&acc)[W / 8][4], const uint32_t (&a)[4][4],
                                           const bf16* b_tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < W / 16; ++np) {
      uint32_t b[4];
      load_b_trans<W>(b, b_tile, 16 * kk, 16 * np, lane);
      mma(acc[2 * np], a[kk], b[0], b[1]);
      mma(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// the accumulator layout of n-tiles 2kk and 2kk+1 is the A fragment of
// k-block kk: (row g, cols 2t, 2t+1), (row g + 8, ...), then the same 8
// columns on
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = hop::pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = hop::pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = hop::pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = hop::pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// rows row0 + g (+ 8) of a 16 x W accumulator into a [rows, W] bf16 matrix
template <int W>
__device__ __forceinline__ void store_rows(bf16* dst, long long stride, const float (&acc)[W / 8][4],
                                           int row0, int limit, float mul, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= limit) continue;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + row * stride + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * h] * mul, acc[j][2 * h + 1] * mul);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS) bwd_dkdv(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BKV][LD<D>]
  bf16* Vs = Ks + BKV * LD<D>;                    // [BKV][LD<DV>]
  bf16* Qs = Vs + BKV * LD<DV>;                   // [BQ][LD<D>]
  bf16* dOs = Qs + BQ * LD<D>;                    // [BQ][LD<DV>]
  float* lse_s = reinterpret_cast<float*>(dOs + BQ * LD<DV>);
  float* dr_s = lse_s + BQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int bk = blockIdx.x, b = bk / p.hkv, hk = bk % p.hkv;
  const int kv0 = blockIdx.y * BKV, r0 = 16 * warp;  // the warp's 16 keys of the tile
  load_tile<D>(Ks, static_cast<const bf16*>(p.k) + b * p.ks.b + hk * p.ks.h, p.ks.s, kv0, BKV,
               p.skv);
  load_tile<DV>(Vs, static_cast<const bf16*>(p.v) + b * p.vs.b + hk * p.vs.h, p.vs.s, kv0, BKV,
                p.skv);

  float dk[D / 8][4], dv[DV / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[j][e] = 0.f;

  const int n_q = (p.sq + BQ - 1) / BQ;
  const int t0 = p.causal ? kv0 / BQ : 0;
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = hk * p.group + gi;
    const bf16* q = static_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.h;
    const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.dos.b + h * p.dos.h;
    const long long row_base = ((long long)b * p.hq + h) * p.sq;
    for (int tile = t0; tile < n_q; ++tile) {
      const int q0 = tile * BQ;
      __syncthreads();  // the last tile's readers are done
      load_tile<D>(Qs, q, p.qs.s, q0, BQ, p.sq);
      load_tile<DV>(dOs, dout, p.dos.s, q0, BQ, p.sq);
      load_stats(lse_s, dr_s, p.lse + row_base, p.dr + row_base, q0, p.sq);
      __syncthreads();

      // P^T = exp(K Q^T * scale - lse): keys r0 + g (+8), queries 8 j + 2 t (+1)
      float s[8][4];
      product_nt<D>(s, Ks, r0, Qs, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kv0 + r0 + g + 8 * (e / 2), qi = 8 * j + 2 * t + e % 2, row = q0 + qi;
          const bool ok = row < p.sq && key < p.skv && (!p.causal || row >= key);
          s[j][e] = ok ? expf(s[j][e] * p.scale - lse_s[qi]) : 0.f;
        }
      uint32_t pa[4][4];
      pack_a(pa, s);
      product_rs<DV>(dv, pa, dOs, lane);  // dV += P^T dO

      // dS^T = P^T (V dO^T - Dr)
      product_nt<DV>(s, Vs, r0, dOs, lane);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 2 * kk + half, qi = 8 * j + 2 * t + e % 2;
            const __nv_bfloat162 pp =
                *reinterpret_cast<const __nv_bfloat162*>(&pa[kk][2 * half + e / 2]);
            const float pv = e % 2 ? __high2float(pp) : __low2float(pp);
            s[j][e] = pv * (s[j][e] - dr_s[qi]);
          }
      pack_a(pa, s);
      product_rs<D>(dk, pa, Qs, lane);  // dK += dS^T Q
    }
  }
  store_rows<D>(static_cast<bf16*>(p.dk) + b * p.dks.b + hk * p.dks.h, p.dks.s, dk, kv0 + r0,
                p.skv, p.scale, lane);
  store_rows<DV>(static_cast<bf16*>(p.dv) + b * p.dvs.b + hk * p.dvs.h, p.dvs.s, dv, kv0 + r0,
                 p.skv, 1.f, lane);
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS) bwd_dq(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD<D>]
  bf16* dOs = Qs + BQ * LD<D>;                    // [BQ][LD<DV>]
  bf16* Ks = dOs + BQ * LD<DV>;                   // [BKV][LD<D>]
  bf16* Vs = Ks + BKV * LD<D>;                    // [BKV][LD<DV>]
  float* lse_s = reinterpret_cast<float*>(Vs + BKV * LD<DV>);
  float* dr_s = lse_s + BQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int tile = gridDim.y - 1 - blockIdx.y;  // the longest causal tiles first
  const int bh = blockIdx.x, b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  const int q0 = tile * BQ, r0 = 16 * warp;  // the warp's 16 queries of the tile
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ks.b + hk * p.ks.h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vs.b + hk * p.vs.h;
  load_tile<D>(Qs, static_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.h, p.qs.s, q0, BQ,
               p.sq);
  load_tile<DV>(dOs, static_cast<const bf16*>(p.dout) + b * p.dos.b + h * p.dos.h, p.dos.s, q0,
                BQ, p.sq);
  const long long row_base = (long long)bh * p.sq;
  load_stats(lse_s, dr_s, p.lse + row_base, p.dr + row_base, q0, p.sq);

  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  int n_kv = (p.skv + BKV - 1) / BKV;
  if (p.causal) n_kv = min(n_kv, (min(q0 + BQ, p.sq) - 1) / BKV + 1);
  for (int jt = 0; jt < n_kv; ++jt) {
    const int kv0 = jt * BKV;
    __syncthreads();  // the last tile's readers are done
    load_tile<D>(Ks, k, p.ks.s, kv0, BKV, p.skv);
    load_tile<DV>(Vs, v, p.vs.s, kv0, BKV, p.skv);
    __syncthreads();

    // P = exp(Q K^T * scale - lse), dS = P (dO V^T - Dr): queries r0 + g
    // (+8), keys 8 j + 2 t (+1)
    float s[8][4], dp[8][4];
    product_nt<D>(s, Qs, r0, Ks, lane);
    product_nt<DV>(dp, dOs, r0, Vs, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = r0 + g + 8 * (e / 2), row = q0 + qi, key = kv0 + 8 * j + 2 * t + e % 2;
        const bool ok = row < p.sq && key < p.skv && (!p.causal || row >= key);
        const float pv = ok ? expf(s[j][e] * p.scale - lse_s[qi]) : 0.f;
        s[j][e] = pv * (dp[j][e] - dr_s[qi]);
      }
    uint32_t dsa[4][4];
    pack_a(dsa, s);
    product_rs<D>(dq, dsa, Ks, lane);  // dQ += dS K
  }
  store_rows<D>(static_cast<bf16*>(p.dq) + b * p.dqs.b + h * p.dqs.h, p.dqs.s, dq, q0 + r0, p.sq,
                p.scale, lane);
}

template <int D, int DV>
cudaError_t run(const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D, DV>();
  static bool configured = false;  // the attributes are set once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dkdv<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(bwd_dq<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  bwd_dkdv<D, DV><<<dim3(batch * p.hkv, (p.skv + BKV - 1) / BKV), THREADS, bytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq<D, DV><<<dim3(batch * p.hq, (p.sq + BQ - 1) / BQ), THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// bf16 with D and DV up to 128 on the tensor cores, the rest on the CUDA cores
template <typename T, int D, int DV>
constexpr bool on_tensor_cores() {
  return sizeof(T) == 2 && D <= 128 && DV <= 128;
}

// the CUDA-core kernels' launches
template <typename T, int D, int DV>
cudaError_t run_simt(const Params& p, int batch, cudaStream_t stream) {
  constexpr int dkdv_bytes = dkdv_floats<D, DV>() * 4, dq_bytes = dq_floats<D, DV>() * 4;
  static bool configured = false;  // the attributes are set once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dkdv<T, D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(bwd_dq<T, D, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  bwd_dkdv<T, D, DV><<<dim3(batch * p.hkv, (p.skv + BKV - 1) / BKV), THREADS, dkdv_bytes,
                       stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq<T, D, DV><<<dim3(batch * p.hq, (p.sq + BQ - 1) / BQ), THREADS, dq_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, int DV>
cudaError_t run(const Params& p, int batch, cudaStream_t stream) {
  bwd_preprocess<T, DV><<<dim3(batch * p.hq, (p.sq + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK),
                          THREADS, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (on_tensor_cores<T, D, DV>())
    return tc::run<D, DV>(p, batch, stream);
  else
    return run_simt<T, D, DV>(p, batch, stream);
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
// of it). lse and dr: float32 [B*Hq, Sq]; lse the forward's, dr scratch
// this call fills. strides: (b, h, s) in elements for q, k, v, o, dout, dq,
// dk and dv, 24 values; the head dim has unit stride. D is q's and k's head
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
