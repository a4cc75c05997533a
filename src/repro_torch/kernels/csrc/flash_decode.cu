// flash_decode: one-token attention of a G-query group over one KV head's
// cache, returned as unnormalized partials (acc[G,D], m[G], l[G]) for a
// log-sum-exp merge: m = max_j s_j, l = sum_j exp(s_j - m),
// acc = sum_j exp(s_j - m) v_j, with s_j = q . k_j * scale over the filled
// slots j < min(kv_len, S).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/kernel.py
// (flash_decode_pallas, body _decode_kernel) and the jnp twin the model
// runs, src/repro/models/layers.py::_decode_partials_jnp.
//
// Bound on the H100: bytes. Each filled slot's K and V rows are read once
// and used for G dot products and G FMAs per element (granite: G = 4, so
// about 2 FLOP per byte in bf16). At the model's decode shape (B 4, 8 KV
// heads, D 64, 2048 filled slots, bf16) that is 16.8 MB of cache, 5 us at
// 3.35 TB/s. So the design keeps many bytes in flight, keeps the CUDA cores
// out of the way, and launches once.
//
// Grid. The cache is cut into chunks of CHUNK slots (128 for D <= 64 in
// bf16, fewer where rows are wider, so a chunk's K and V rows stay within
// 44 KB of shared memory). Each (b*Hkv + h) gets `split` blocks of 128
// threads (chosen by the caller: about two blocks an SM over all (b, h), at
// most 64); block y takes chunks y, y + split, ... of the filled ones. At
// the model's shape that is 16 blocks of one 128-slot chunk each for each
// of the 32 (b, h): 512 blocks, all resident at once. A block past the
// filled length exits at once; the filled length is read on the device from
// `kv_len` (an int32), so a decode step needs no host sync (a null pointer
// means `kv_len_host`).
//
// Block. Each warp owns a quarter of the chunk. It first issues cp.async
// 16-byte copies of all its K and V rows into shared memory (commit groups
// of 16 slots), then consumes them as they land, in one online-softmax
// sweep that keeps m, l and the p v accumulators in registers (no score
// array; K and V read together).
//   bf16 (decode_tc): tensor cores, mma.sync m16n8k16 with the G queries
//     as the rows of M (G <= 8, so rows 8-15 are zero): S = Q K^T with K's
//     [slot, D] rows as the column-major B; P goes to the A registers of O
//     += P V straight from the accumulator fragments, split into bf16 hi
//     and lo parts (two products) so the f32 partials keep the 2e-4 bar;
//     V arrives as B by ldmatrix.trans. Rows are padded to D + 8 values,
//     which puts the 8 rows of a fragment on distinct banks.
//   f32 (decode_simt): CUDA cores, f32 products (the bar rules out TF32):
//     D/8 lanes hold one slot's row, 8 values each, a dot is an xor-shuffle
//     sum, and the scores of several slots come before one rescale.
// The warps merge through shared memory. With one block in use for (b, h)
// it writes the result. Otherwise it writes its partial, and the last block
// of its (b, h) to finish, found by a per-(b, h) int32 ticket
// (__threadfence, then atomicAdd), merges the partials with
// ref.merge_partials's math in the same launch, reading each once with the
// loads in flight together, and resets its ticket to 0 for the next call or
// CUDA-graph replay. The cache is read in the model's [B, S, Hkv, D] layout
// through strides (unit stride on D, 16-byte aligned rows).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "wgmma.cuh"

namespace fdk {

constexpr int THREADS = 128, WARPS = 4, VEC = 8, GMAX = 8, SMEM_CAP = 44 * 1024;
constexpr int MAX_SPLIT = 64;  // blocks per (b, h), so partials per merge
constexpr float NEG = -1e30f, LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// cache slots per chunk: the largest power of two up to 128 whose K and V
// rows, padded to d + 8 values, fit in SMEM_CAP bytes
__host__ __device__ constexpr int chunk_for(int d, int elem) {
  int c = 128;
  while (c > 8 && c * 2 * (d + 8) * elem > SMEM_CAP) c /= 2;
  return c;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  float* acc;  // the result: [B*H, G, D], [B*H, G], [B*H, G]
  float* m;
  float* l;
  float* acc_part;  // per-block partials: [split, B*H, G, (D)]
  float* m_part;
  float* l_part;
  int* tickets;  // [B*H], 0 between calls
  const int* len_dev;
  int len_host, H, G, S;
  long long qb, qh, qg, kb, kh, ks, vb, vh, vs;
  float scale;
};

__device__ __forceinline__ float ex(float x) { return hop::exp2_approx(x * LOG2E); }

// cp.async.wait_group takes an immediate; a warp has at most two commit
// groups in flight, and n is a constant after unrolling
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n == 0) hop::cp_async_wait<0>();
  else hop::cp_async_wait<1>();
}

// What a block starts from: its (b, h), the filled length, and how many
// blocks of (b, h) have work.
struct Block {
  int bh, n_bh, split, b, h, n, n_chunks, n_act;
};

template <int CHUNK>
__device__ __forceinline__ Block block_of(const Params& p) {
  Block k;
  k.bh = blockIdx.x;
  k.n_bh = gridDim.x;
  k.split = gridDim.y;
  k.b = k.bh / p.H;
  k.h = k.bh % p.H;
  k.n = min(p.len_dev ? *p.len_dev : p.len_host, p.S);
  k.n_chunks = max(1, (k.n + CHUNK - 1) / CHUNK);
  k.n_act = min(k.split, k.n_chunks);
  return k;
}

// rows [r0, r0 + nr) of the warp's slots into K and V rows of LD values;
// slots at or past e are zero-filled (cp.async src-size 0), so a zero
// weight never meets stale bits that read as NaN
template <typename T, int D, int LD>
__device__ __forceinline__ void issue_rows(const Params& p, const T* k, const T* v,
                                           T* k_s, T* v_s, int ws0, int r0, int nr,
                                           int e) {
  constexpr int ROWC = D * sizeof(T) / 16, EPC = 16 / sizeof(T);  // 16-byte pieces
  const int lane = threadIdx.x % 32;
  for (int i = lane; i < nr * 2 * ROWC; i += 32) {
    const int r = r0 + i / (2 * ROWC), pc = i % (2 * ROWC), slot = ws0 + r;
    const bool ok = slot < e;
    const bool is_v = pc >= ROWC;
    const int off = (pc % ROWC) * EPC;
    const T* src = ok ? (is_v ? v + slot * p.vs : k + slot * p.ks) + off : k;
    hop::cp_async16(hop::smem_u32((is_v ? v_s : k_s) + r * LD + off), src, ok);
  }
}

// After each warp has put its m, l and accumulators into red_m, red_l and
// red_acc ([WARPS][GM](D), at the start of shared memory): merge the warps,
// write the result or this block's partial, and if this block is the last
// of its (b, h), merge the partials.
template <int D, int GM>
__device__ __forceinline__ void block_finish(const Params& p, const Block& k,
                                             unsigned char* smem, int* s_last) {
  const int tid = threadIdx.x;
  const float* red_acc = reinterpret_cast<const float*>(smem);
  const float* red_m = red_acc + WARPS * GM * D;
  const float* red_l = red_m + WARPS * GM;
  const bool direct = k.n_act == 1;
  const size_t part = direct ? k.bh : (size_t)blockIdx.y * k.n_bh + k.bh;
  float* acc_o = (direct ? p.acc : p.acc_part) + part * p.G * D;
  float* m_o = (direct ? p.m : p.m_part) + part * p.G;
  float* l_o = (direct ? p.l : p.l_part) + part * p.G;
  for (int i = tid; i < p.G * D; i += THREADS) {
    const int g = i / D;
    float mx = NEG, num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, red_m[w * GM + g]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = ex(red_m[w * GM + g] - mx);
      num = fmaf(wt, red_acc[(w * GM + g) * D + i % D], num);
      den = fmaf(wt, red_l[w * GM + g], den);
    }
    acc_o[i] = num;
    if (i % D == 0) {
      m_o[g] = mx;
      l_o[g] = den;
    }
  }
  if (direct) return;

  // the last block of this (b, h) to finish merges the n_act partials
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    *s_last = atomicAdd(p.tickets + k.bh, 1) == k.n_act - 1;
    if (*s_last) p.tickets[k.bh] = 0;  // every block of (b, h) has taken its ticket
  }
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  // the partials' m and l into shared memory (one round trip), then each
  // output's sum over the partials with all their loads in flight
  float* s_m = reinterpret_cast<float*>(smem);  // [MAX_SPLIT][GMAX]
  float* s_l = s_m + MAX_SPLIT * GMAX;
  for (int i = tid; i < k.n_act * p.G; i += THREADS) {
    const int sp = i / p.G, g = i % p.G;
    const size_t at = ((size_t)sp * k.n_bh + k.bh) * p.G + g;
    s_m[sp * GMAX + g] = __ldcg(p.m_part + at);
    s_l[sp * GMAX + g] = __ldcg(p.l_part + at);
  }
  __syncthreads();
  auto merged_m = [&](int g) {
    float mx = NEG;
    for (int sp = 0; sp < k.n_act; ++sp) mx = fmaxf(mx, s_m[sp * GMAX + g]);
    return mx;
  };
  if (tid < p.G) {
    const float mx = merged_m(tid);
    float den = 0.f;
    for (int sp = 0; sp < k.n_act; ++sp)
      den = fmaf(ex(s_m[sp * GMAX + tid] - mx), s_l[sp * GMAX + tid], den);
    p.m[(size_t)k.bh * p.G + tid] = mx;
    p.l[(size_t)k.bh * p.G + tid] = den;
  }
  // two outputs per pass, so twice as many loads are in flight
  const int n_out = p.G * D;
  const float* parts = p.acc_part + (size_t)k.bh * n_out;
  const size_t stride = (size_t)k.n_bh * n_out;  // from one partial to the next
  for (int i0 = tid; i0 < n_out; i0 += 2 * THREADS) {
    const int i1 = min(i0 + THREADS, n_out - 1), g0 = i0 / D, g1 = i1 / D;
    const float m0 = merged_m(g0), m1 = merged_m(g1);
    float n0 = 0.f, n1 = 0.f;
#pragma unroll 16
    for (int sp = 0; sp < k.n_act; ++sp) {
      n0 = fmaf(ex(s_m[sp * GMAX + g0] - m0), __ldcg(parts + sp * stride + i0), n0);
      n1 = fmaf(ex(s_m[sp * GMAX + g1] - m1), __ldcg(parts + sp * stride + i1), n1);
    }
    p.acc[(size_t)k.bh * n_out + i0] = n0;
    if (i0 + THREADS < n_out) p.acc[(size_t)k.bh * n_out + i1] = n1;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// C += A B, m16n8k16, bf16 in, f32 accumulators; rows 8-15 of A (a1, a3)
// are zero: the G <= 8 queries fill rows 0-7
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a2,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int D>
constexpr int smem_tc() {
  constexpr int rows = chunk_for(D, 2) * 2 * (D + 8) * 2;
  constexpr int red = (WARPS * GMAX * D + 2 * WARPS * GMAX) * 4;
  constexpr int fin = 2 * MAX_SPLIT * GMAX * 4;  // the final merge's m and l
  constexpr int most = red > fin ? red : fin;
  return rows > most ? rows : most;
}

template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 4 : 2) decode_tc(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int CHUNK = chunk_for(D, 2), WS = CHUNK / WARPS, LD = D + 8;
  constexpr int NG = WS / 16, NT = D / 8;  // 16-slot groups per warp, 8-column tiles of O
  static_assert(WS % 16 == 0 && NG <= 2 && NT % 2 == 0, "chunk");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;

  const Block k = block_of<CHUNK>(p);
  if (blockIdx.y >= k.n_act) return;  // past the filled length
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row (the query) and column pair

  const bf16* q = static_cast<const bf16*>(p.q) + k.b * p.qb + k.h * p.qh;
  const bf16* kp = static_cast<const bf16*>(p.k) + k.b * p.kb + k.h * p.kh;
  const bf16* vp = static_cast<const bf16*>(p.v) + k.b * p.vb + k.h * p.vh;
  bf16* k_s = reinterpret_cast<bf16*>(smem) + warp * 2 * WS * LD;  // [WS][LD]
  bf16* v_s = k_s + WS * LD;

  float o[NT][4], m = NEG, l = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  uint32_t qa[D / 16][2];  // A fragments of Q: row g, columns 16 kk + 2 t (+ 8)

  for (int c = blockIdx.y; c < k.n_chunks; c += k.split) {
    const int ws0 = c * CHUNK + warp * WS, e = min(c * CHUNK + CHUNK, k.n);
    __syncwarp();  // the warp is done with its rows of the previous chunk
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      issue_rows<bf16, D, LD>(p, kp, vp, k_s, v_s, ws0, 16 * gi, 16, e);
      hop::cp_async_commit();
    }
    if (c == blockIdx.y) {  // q, while the first copies are in flight
      const unsigned short* qr = reinterpret_cast<const unsigned short*>(q + g * p.qg);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int d = 16 * kk + 8 * h2 + 2 * t;
          qa[kk][h2] = g < p.G ? (uint32_t)qr[d] | ((uint32_t)qr[d + 1] << 16) : 0u;
        }
    }

#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      cp_async_wait_n(NG - 1 - gi);
      __syncwarp();
      if (ws0 + 16 * gi >= e) continue;  // the whole group is past the filled length
      // S = Q K^T over the group's 16 slots: two 8-slot tiles
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
        const bf16* kr = k_s + (16 * gi + 8 * j + g) * LD + 2 * t;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_bf16(s[j], qa[kk][0], qa[kk][1],
                   *reinterpret_cast<const uint32_t*>(kr + 16 * kk),
                   *reinterpret_cast<const uint32_t*>(kr + 16 * kk + 8));
      }
      // online softmax of row g over columns 8 j + 2 t + i, the 4 threads
      // of a quad holding the row
      float x[2][2], mx = m;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int slot = ws0 + 16 * gi + 8 * j + 2 * t + i;
          x[j][i] = slot < e ? s[j][i] * p.scale : NEG;
          mx = fmaxf(mx, x[j][i]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float a = ex(m - mx);
      m = mx;
      l *= a;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= a;
        o[n][1] *= a;
      }
      float pr[2][2], lo[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pr[j][i] = ex(x[j][i] - m);
          l += pr[j][i];
          lo[j][i] = pr[j][i] - bf16_round(pr[j][i]);
        }
      // P as the A operand of a 16-slot k-step: a0 = columns 2t, 2t+1 of
      // tile 0, a2 = the same of tile 1; hi and lo parts
      const uint32_t ph0 = hop::pack_bf16(pr[0][0], pr[0][1]);
      const uint32_t ph2 = hop::pack_bf16(pr[1][0], pr[1][1]);
      const uint32_t pl0 = hop::pack_bf16(lo[0][0], lo[0][1]);
      const uint32_t pl2 = hop::pack_bf16(lo[1][0], lo[1][1]);
      // O += P V: B of tile n is V[slots 2t, 2t+1 (and + 8)][column 8 n + g];
      // lanes 0-15 address the group's 16 rows at column 8 n, lanes 16-31
      // at column 8 n + 8
      const uint32_t vrow =
          hop::smem_u32(v_s + (16 * gi + lane % 16) * LD + 8 * (lane / 16));
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b[4];
        hop::ldmatrix_x4_trans(vrow + 16 * n, b);
        mma_bf16(o[n], ph0, ph2, b[0], b[1]);
        mma_bf16(o[n], pl0, pl2, b[0], b[1]);
        mma_bf16(o[n + 1], ph0, ph2, b[2], b[3]);
        mma_bf16(o[n + 1], pl0, pl2, b[2], b[3]);
      }
    }
  }
  hop::cp_async_wait<0>();

  // the warp's result: row g's l is spread over its quad
  l += __shfl_xor_sync(FULL, l, 1);
  l += __shfl_xor_sync(FULL, l, 2);
  __syncthreads();  // every warp is done with its rows
  float* red_acc = reinterpret_cast<float*>(smem);  // [WARPS][GMAX][D]
  float* red_m = red_acc + WARPS * GMAX * D;
  float* red_l = red_m + WARPS * GMAX;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    red_acc[(warp * GMAX + g) * D + 8 * n + 2 * t] = o[n][0];
    red_acc[(warp * GMAX + g) * D + 8 * n + 2 * t + 1] = o[n][1];
  }
  if (t == 0) {
    red_m[warp * GMAX + g] = m;
    red_l[warp * GMAX + g] = l;
  }
  __syncthreads();
  block_finish<D, GMAX>(p, k, smem, &s_last);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

template <int D>
struct Layout {
  static constexpr int LPS = D / VEC;  // lanes holding one slot's row
  static constexpr int LANES = LPS <= 1 ? 1 : LPS <= 2 ? 2 : LPS <= 4 ? 4
                             : LPS <= 8 ? 8 : LPS <= 16 ? 16 : 32;
  static constexpr int SPW = 32 / LANES;  // slots per warp per step
  static_assert(D % VEC == 0 && LPS <= 32, "head dim");
};

__device__ __forceinline__ void load8(const float* p, float (&x)[VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

template <int D>
constexpr int smem_simt(int gm) {
  const int rows = chunk_for(D, 4) * 2 * D * 4;
  const int red = (WARPS * gm * D + 2 * WARPS * gm) * 4;
  const int fin = 2 * MAX_SPLIT * GMAX * 4;  // the final merge's m and l
  const int most = red > fin ? red : fin;
  return rows > most ? rows : most;
}

template <int D, int GM>
__global__ void __launch_bounds__(THREADS, GM <= 4 ? 4 : 2) decode_simt(Params p) {
  using L = Layout<D>;
  constexpr int CHUNK = chunk_for(D, 4), WS = CHUNK / WARPS;
  constexpr int STEPS = WS / L::SPW;
  constexpr int NGRP = STEPS >= 8 ? 2 : 1, GS = WS / NGRP;
  constexpr int NS = GS / L::SPW;  // slots of a lane group in one commit group
  static_assert(NS >= 1 && GS % L::SPW == 0, "chunk");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;

  const Block k = block_of<CHUNK>(p);
  if (blockIdx.y >= k.n_act) return;  // past the filled length
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / L::LANES, gl = lane % L::LANES, d0 = gl * VEC;
  const bool active = gl < L::LPS;

  const float* q = static_cast<const float*>(p.q) + k.b * p.qb + k.h * p.qh;
  const float* kp = static_cast<const float*>(p.k) + k.b * p.kb + k.h * p.kh;
  const float* vp = static_cast<const float*>(p.v) + k.b * p.vb + k.h * p.vh;
  float* k_s = reinterpret_cast<float*>(smem) + warp * 2 * WS * D;  // [WS][D]
  float* v_s = k_s + WS * D;

  float qf[GM][VEC], acc[GM][VEC], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }
  for (int c = blockIdx.y; c < k.n_chunks; c += k.split) {
    const int ws0 = c * CHUNK + warp * WS, e = min(c * CHUNK + CHUNK, k.n);
    __syncwarp();  // the warp is done with its rows of the previous chunk
#pragma unroll
    for (int gi = 0; gi < NGRP; ++gi) {
      issue_rows<float, D, D>(p, kp, vp, k_s, v_s, ws0, gi * GS, GS, e);
      hop::cp_async_commit();
    }
    if (c == blockIdx.y) {  // q, while the first copies are in flight
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          qf[g][i] = g < p.G && active ? q[g * p.qg + d0 + i] * p.scale : 0.f;
    }

    // commit group by commit group as they land: the NS scores of each
    // lane group first, then one rescale
#pragma unroll
    for (int gi = 0; gi < NGRP; ++gi) {
      cp_async_wait_n(NGRP - 1 - gi);
      __syncwarp();
      float sc[NS][GM];
#pragma unroll
      for (int st = 0; st < NS; ++st) {
        float kf[VEC];
        if (active) {
          load8(k_s + (gi * GS + st * L::SPW + grp) * D + d0, kf);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) kf[i] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < VEC; ++i) s = fmaf(qf[g][i], kf[i], s);
          sc[st][g] = s;
        }
      }
#pragma unroll
      for (int off = L::LANES / 2; off > 0; off >>= 1)
#pragma unroll
        for (int st = 0; st < NS; ++st)
#pragma unroll
          for (int g = 0; g < GM; ++g) sc[st][g] += __shfl_xor_sync(FULL, sc[st][g], off);
      bool ok[NS];
#pragma unroll
      for (int st = 0; st < NS; ++st) ok[st] = ws0 + gi * GS + st * L::SPW + grp < e;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float mx = m[g];
#pragma unroll
        for (int st = 0; st < NS; ++st)
          if (ok[st]) mx = fmaxf(mx, sc[st][g]);
        const float a = ex(m[g] - mx);
        m[g] = mx;
        l[g] *= a;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] *= a;
      }
#pragma unroll
      for (int st = 0; st < NS; ++st) {
        if (!ok[st]) continue;
        float vf[VEC];
        if (active) {
          load8(v_s + (gi * GS + st * L::SPW + grp) * D + d0, vf);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) vf[i] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float pr = ex(sc[st][g] - m[g]);
          l[g] += pr;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(pr, vf[i], acc[g][i]);
        }
      }
    }
  }

  // merge the lane groups of the warp (lanes gl, gl + LANES, ...)
#pragma unroll
  for (int off = L::LANES; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(FULL, m[g], off), lo = __shfl_xor_sync(FULL, l[g], off);
      const float mn = fmaxf(m[g], mo), a = ex(m[g] - mn), c = ex(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[g][i] = acc[g][i] * a + __shfl_xor_sync(FULL, acc[g][i], off) * c;
      m[g] = mn;
    }
  }

  __syncthreads();  // every warp is done with its rows
  float* red_acc = reinterpret_cast<float*>(smem);  // [WARPS][GM][D]
  float* red_m = red_acc + WARPS * GM * D;
  float* red_l = red_m + WARPS * GM;
  if (grp == 0 && active) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int i = 0; i < VEC; ++i) red_acc[(warp * GM + g) * D + d0 + i] = acc[g][i];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      red_m[warp * GM + g] = m[g];
      red_l[warp * GM + g] = l[g];
    }
  }
  __syncthreads();
  block_finish<D, GM>(p, k, smem, &s_last);
}

template <int D>
cudaError_t launch_f32(const Params& p, dim3 grid, cudaStream_t s) {
  if (p.G <= 1) decode_simt<D, 1><<<grid, THREADS, smem_simt<D>(1), s>>>(p);
  else if (p.G <= 2) decode_simt<D, 2><<<grid, THREADS, smem_simt<D>(2), s>>>(p);
  else if (p.G <= 4) decode_simt<D, 4><<<grid, THREADS, smem_simt<D>(4), s>>>(p);
  else decode_simt<D, 8><<<grid, THREADS, smem_simt<D>(8), s>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Params& p, dim3 grid, cudaStream_t s) {
  decode_tc<D><<<grid, THREADS, smem_tc<D>(), s>>>(p);
  return cudaGetLastError();
}

cudaError_t launch(const Params& p, dim3 grid, int d, bool bf16, cudaStream_t s) {
  switch (d) {
    case 16: return bf16 ? launch_bf16<16>(p, grid, s) : launch_f32<16>(p, grid, s);
    case 32: return bf16 ? launch_bf16<32>(p, grid, s) : launch_f32<32>(p, grid, s);
    case 64: return bf16 ? launch_bf16<64>(p, grid, s) : launch_f32<64>(p, grid, s);
    case 128: return bf16 ? launch_bf16<128>(p, grid, s) : launch_f32<128>(p, grid, s);
    case 160: return bf16 ? launch_bf16<160>(p, grid, s) : launch_f32<160>(p, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fdk

// Cache slots per chunk for head dim d and dtype (0 = float32, 1 =
// bfloat16), 0 if there is no instance.
extern "C" int flash_decode_chunk(int d, int dtype) {
  if (d != 16 && d != 32 && d != 64 && d != 128 && d != 160) return 0;
  if (dtype != 0 && dtype != 1) return 0;
  return fdk::chunk_for(d, dtype == 0 ? 4 : 2);
}

// dtype: 0 = float32, 1 = bfloat16. q is [B, H, G, D] and k, v are
// [B, H, S, D] through strides (b, h, g|s) in elements, 9 values; D has
// unit stride. acc [B*H, G, D], m and l [B*H, G] are float32. `split`
// blocks per (b, h) (at most 64 and ceil(S / chunk)) take chunks split
// apart; with split > 1 the *_part buffers hold split times as much as the
// results and `tickets` B*H int32 zeros, which the kernel leaves zero.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            float* acc, float* m, float* l, float* acc_part,
                            float* m_part, float* l_part, int* tickets,
                            const int* kv_len, int kv_len_host, int B, int H, int G,
                            int S, int D, int split, int dtype, float scale,
                            const long long* strides, void* stream) {
  const int chunk = flash_decode_chunk(D, dtype);
  if (B <= 0 || H <= 0 || G <= 0 || G > fdk::GMAX || S <= 0 || chunk == 0 ||
      split < 1 || split > fdk::MAX_SPLIT || split > (S + chunk - 1) / chunk ||
      (split > 1 && !(acc_part && m_part && l_part && tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  fdk::Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.acc = acc;
  p.m = m;
  p.l = l;
  p.acc_part = acc_part;
  p.m_part = m_part;
  p.l_part = l_part;
  p.tickets = tickets;
  p.len_dev = kv_len;
  p.len_host = kv_len_host;
  p.H = H;
  p.G = G;
  p.S = S;
  p.qb = strides[0]; p.qh = strides[1]; p.qg = strides[2];
  p.kb = strides[3]; p.kh = strides[4]; p.ks = strides[5];
  p.vb = strides[6]; p.vh = strides[7]; p.vs = strides[8];
  p.scale = scale;
  const dim3 grid(B * H, split);
  return static_cast<int>(fdk::launch(p, grid, D, dtype == 1,
                                      static_cast<cudaStream_t>(stream)));
}
