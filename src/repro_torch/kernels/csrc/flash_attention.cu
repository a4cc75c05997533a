// flash_attention: prefill attention with an online softmax over KV blocks.
// o[b,h,i,:] = softmax_j(q[b,h,i,:] . k[b,h/G,j,:] * scale) @ v[b,h/G,:,:]
// with key padding (j < Skv) and, if causal, the top-left mask i >= j. q and
// k have head dim D, v and o head dim DV: DV == D for the GQA families, and
// (D, DV) = (192, 128) for MLA's prefill (deepseek-v2: nope 128 + rope 64
// against v 128), whose scale is D^-0.5 as the reference's.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, body _flash_kernel) and the jnp twin the model
// runs, src/repro/models/layers.py::jnp_flash_attention.
//
// Bound on the H100: operations. At the model's prefill shape (B 4, S 2048,
// 32 query heads over 8 KV heads, D 64, causal, bf16) the work is 68.7
// GFLOP against 84 MB of q, k, v and o, about 800 FLOP per byte: 0.069 ms
// at the 989 TFLOP/s of the bf16 tensor cores.
//
// Two instances, picked by the input type in the C entry below, each
// templated on the pair (D, DV); the C entry takes the pairs (16, 16), (32,
// 32), (64, 64), (128, 128), (160, 160), (192, 128) and (64, 32), and
// refuses any other:
//
// bf16: tensor cores (flash_fwd_bf16). One 256-thread block per (b*Hq + h,
// 128-row q tile), two warpgroups of 64 rows each. The q tile is copied
// once into shared memory; K and V arrive in 64-key tiles by cp.async
// 16-byte copies into a ring of two stages, so tile j+1 is in flight while
// tile j is computed (rows past Skv are zero-filled by the copy). Tiles are
// stored in the swizzled layouts wgmma reads (wgmma.cuh): rows of 128 bytes
// (D >= 64, as 64-column atoms; D 160 takes three, the last half used), 64
// bytes (D 32) or 32 bytes (D 16); Q and K in the atoms of D, V in those of
// DV (at (192, 128): Q 48 KB, K 24 and V 16 KB a stage, 129 KB in all, one
// block an SM). Per tile and warpgroup:
//   S = Q K^T  wgmma m64n64k16, Q and K from shared memory, both K-major
//              (K's [key, D] rows are what B wants; no transpose copy);
//   softmax    on the accumulator fragments: each thread holds 2 rows x 16
//              columns, the row max is a max over the 4 threads of a quad,
//              the scale is folded with log2(e) into exp2, and only tiles
//              on the causal diagonal or past Skv are masked; the row sum
//              stays per thread until the end;
//   O += P V   wgmma m64nNk16 (N <= 64 per instruction, DV/64 of them for
//              DV >= 64), A = P converted to
//              bf16 in place: the f32 accumulator fragment of S is the
//              register layout A takes, so P never goes through shared
//              memory; B = V from shared memory, MN-major (transpose bit).
// P in bf16 is what the TPU kernel computes too: its jnp.dot(p, v) rounds
// p to bf16 on the MXU at default precision. m, l and O stay in f32.
//
// f32: CUDA cores (flash_fwd_f32). The f32 path's 2e-4 bar rules out bf16
// tensor cores and TF32, so it computes in f32 FMA: one 256-thread block per
// (b*Hq + h, 64-row q tile), 64x64 register tiles (thread (ty, tx) owns rows
// ty + 16*i and cols tx + 16*j), P through shared memory, V and the output
// accumulators sized by DV (148 KB of shared memory at (192, 128)). Its
// ceiling is the 67 TFLOP/s f32 rate; the LM's timed path is bf16.
//
// lse: given a non-null pointer (training's forward), both instances also
// write each row's log-sum-exp of its scaled scores, m + log(l) in natural
// log, float32 [B*Hq, Sq], from the row max and sum they already hold: what
// the backward (flash_attention_bwd.cu) recomputes P from. With a null
// pointer nothing else changes.
//
// Both: the KV head h / G is read in place (no repeat copy), strides over
// B, H and S are arguments (unit stride on D), ragged S is masked on load
// and on store (no padding copies), the grid's x is b*Hq + h (no 65535
// limit) and its y walks the q tiles from the last to the first so the long
// causal tiles start first, and KV tiles that the causal mask covers
// entirely are skipped. That skip is exact: once the first tile has set m,
// such a tile's p = exp(-1e30 - m) is 0 and its alpha is 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace fa {

constexpr float NEG = -1e30f;

struct Strides { long long b, h, s; };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B*Hq, Sq] or null
  Strides qs, ks, vs, os;
  int hq, group, sq, skv, causal;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------

namespace tc {

constexpr int WGS = 2, BQ = 64 * WGS, BKV = 64, THREADS = 128 * WGS, STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

template <int D>
struct Geo {
  static constexpr int ACOLS = D >= 64 ? 64 : D;  // bf16 columns of an atom
  static constexpr int SW = ACOLS * 2;              // bytes per atom row
  static constexpr int CHUNKS = SW / 16;            // 16-byte chunks per atom row
  static constexpr int NATOM = (D + ACOLS - 1) / ACOLS;
  static constexpr int Q_ATOM = BQ * SW;
  static constexpr int KV_ATOM = BKV * SW;
  static constexpr int Q_BYTES = NATOM * Q_ATOM;
  static constexpr int KV_BYTES = NATOM * KV_ATOM;  // K or V, one stage
  static_assert(D % 16 == 0 && ACOLS % 16 == 0, "head dim");
};

// shared memory of one block: Q in D's atoms, then per stage K (D's atoms)
// and V (DV's atoms); every offset a multiple of 1024 bytes
template <int D, int DV>
struct Smem {
  static constexpr int K_BYTES = Geo<D>::KV_BYTES, V_BYTES = Geo<DV>::KV_BYTES;
  static constexpr int STAGE = K_BYTES + V_BYTES;
  static constexpr int TOTAL = Geo<D>::Q_BYTES + STAGES * STAGE + 1024;  // + alignment
};

// rows [row0, row0 + n) of a [rows, D] bf16 matrix (row stride `stride`)
// into the atoms at `dst`, rows at or past `limit` zero-filled
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          long long stride, int row0, int n, int limit,
                                          int atom_bytes) {
  using G = Geo<D>;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < n * CPR; i += THREADS) {
    const int r = i / CPR, ci = i % CPR, row = row0 + r;
    const bool ok = row < limit;
    const __nv_bfloat16* s = ok ? src + row * stride + ci * 8 : src;
    hop::cp_async16(dst + (ci / G::CHUNKS) * atom_bytes +
                        hop::swizzle<G::SW>(r, ci % G::CHUNKS), s, ok);
  }
}

// O (+)= P V over one atom of V's columns; o holds DV/2 accumulators
template <int DV, int A>
__device__ __forceinline__ void pv_atom(float (&o)[DV / 2], const uint32_t* pa,
                                        uint32_t v_kk) {
  using G = Geo<DV>;
  constexpr int N = DV - A * G::ACOLS < G::ACOLS ? DV - A * G::ACOLS : G::ACOLS;
  const uint64_t db = hop::make_desc<G::SW>(v_kk + A * G::KV_ATOM, 8 * G::SW);
  if constexpr (N == 64) hop::wgmma_rs_n64<A * 32>(o, pa, db);
  else if constexpr (N == 32) hop::wgmma_rs_n32<A * 32>(o, pa, db);
  else hop::wgmma_rs_n16<A * 32>(o, pa, db);
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1) flash_fwd_bf16(Params p) {
  using G = Geo<D>;
  using GV = Geo<DV>;
  using SM = Smem<D, DV>;
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (hop::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + G::Q_BYTES;  // stage st: K, then V

  const int tile = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  const int q0 = tile * BQ;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.h;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ks.b + hk * p.ks.h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vs.b + hk * p.vs.h;
  bf16* o = static_cast<bf16*>(p.o) + b * p.os.b + h * p.os.h;

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, quad = lane % 4;
  const int row0 = q0 + 64 * wg;               // this warpgroup's first row
  const int ra = row0 + 16 * warp + lane / 4;  // the thread's rows: ra, ra + 8

  const int n_all = (p.skv + BKV - 1) / BKV;
  int n_kv = n_all, wg_tiles = row0 < p.sq ? n_all : 0;
  if (p.causal) {
    n_kv = min(n_all, (min(q0 + BQ, p.sq) - 1) / BKV + 1);
    if (row0 < p.sq) wg_tiles = min(n_all, (min(row0 + 64, p.sq) - 1) / BKV + 1);
  }

  auto load_kv = [&](int st, int j) {
    const uint32_t ks = kv_s + st * SM::STAGE;
    load_tile<D>(ks, k, p.ks.s, j * BKV, BKV, p.skv, G::KV_ATOM);
    load_tile<DV>(ks + SM::K_BYTES, v, p.vs.s, j * BKV, BKV, p.skv, GV::KV_ATOM);
  };
  load_tile<D>(q_s, q, p.qs.s, q0, BQ, p.sq, G::Q_ATOM);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_kv) load_kv(st, st);
    hop::cp_async_commit();
  }

  float s[32], acc[DV / 2], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  uint32_t pa[16];
  const float sl2 = p.scale * LOG2E;

  for (int j = 0; j < n_kv; ++j) {
    hop::cp_async_wait<STAGES - 2>();  // tile j has landed (this thread's copies)
    hop::fence_proxy_async();
    __syncthreads();  // ... everyone's; and tile j-1's stage is free again
    {
      const int jn = j + STAGES - 1;
      if (jn < n_kv) load_kv(jn % STAGES, jn);
      hop::cp_async_commit();
    }
    if (j >= wg_tiles) continue;  // uniform per warpgroup
    const uint32_t k_s = kv_s + (j % STAGES) * SM::STAGE, v_s = k_s + SM::K_BYTES;

    // S = Q K^T
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int atom = kk / (G::ACOLS / 16);
      const uint32_t off = (kk % (G::ACOLS / 16)) * 32;  // 16 columns, in bytes
      const uint64_t da =
          hop::make_desc<G::SW>(q_s + atom * G::Q_ATOM + 64 * wg * G::SW + off, 16);
      const uint64_t db = hop::make_desc<G::SW>(k_s + atom * G::KV_ATOM + off, 16);
      hop::wgmma_ss_n64<0>(s, da, db, kk > 0);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(s);

    // online softmax on the fragments: s[4i + e] is row ra + 8 * (e / 2),
    // column c0 + 8 i + 2 quad + e % 2
    const int c0 = j * BKV;
    const bool edge = c0 + BKV > p.skv || (p.causal && c0 + BKV - 1 > row0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * i + e] * sl2;
        if (edge) {
          const int col = c0 + 8 * i + 2 * quad + (e & 1), row = ra + 8 * (e >> 1);
          if (col >= p.skv || (p.causal && row < col)) x = NEG;
        }
        s[4 * i + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = hop::exp2_approx(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float pv = hop::exp2_approx(s[i] - m[(i >> 1) & 1]);
      s[i] = pv;
      l[(i >> 1) & 1] += pv;
    }
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < 16; ++i) pa[i] = hop::pack_bf16(s[2 * i], s[2 * i + 1]);

    // O += P V: A's k-step kk is S's columns 16 kk .. 16 kk + 15, i.e.
    // registers pa[4 kk .. 4 kk + 3]
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t v_kk = v_s + kk * 16 * GV::SW;
      pv_atom<DV, 0>(acc, pa + 4 * kk, v_kk);
      if constexpr (GV::NATOM > 1) pv_atom<DV, 1>(acc, pa + 4 * kk, v_kk);
      if constexpr (GV::NATOM > 2) pv_atom<DV, 2>(acc, pa + 4 * kk, v_kk);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    hop::fence_regs(pa);
  }
  hop::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = ra + 8 * r;
    if (row >= p.sq) continue;
    // m is in log2 units (the scale folded with log2(e))
    if (p.lse != nullptr && quad == 0)
      p.lse[(long long)bh * p.sq + row] = (m[r] + log2f(fmaxf(l[r], 1e-30f))) * LN2;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = o + row * p.os.s + 2 * quad;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
  }
}

template <int D, int DV>
cudaError_t launch(const Params& p, int n_bh, cudaStream_t stream) {
  constexpr int bytes = Smem<D, DV>::TOTAL;
  static bool configured = false;  // the attribute is set once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(n_bh, (p.sq + BQ - 1) / BQ);
  flash_fwd_bf16<D, DV><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BQ = 64, BKV = 64, THREADS = 256;

template <int D, int DV>
constexpr int smem_floats() {
  return BQ * (D + 1) + BKV * (D + 1) + BKV * DV + BQ * (BKV + 1);
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32(Params p) {
  constexpr int LD = D + 1, LP = BKV + 1, DC = DV / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][LD]
  float* Ks = Qs + BQ * LD;     // [BKV][LD]
  float* Vs = Ks + BKV * LD;    // [BKV][DV]
  float* Ps = Vs + BKV * DV;    // [BQ][LP]

  const int tile = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  const int q0 = tile * BQ;
  const float* q = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h;
  const float* k = static_cast<const float*>(p.k) + b * p.ks.b + hk * p.ks.h;
  const float* v = static_cast<const float*>(p.v) + b * p.vs.b + hk * p.vs.h;
  float* o = static_cast<float*>(p.o) + b * p.os.b + h * p.os.h;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D, row = q0 + r;
    Qs[r * LD + d] = row < p.sq ? q[row * p.qs.s + d] : 0.f;
  }

  float acc[4][DC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_kv = (p.skv + BKV - 1) / BKV;
  if (p.causal) n_kv = min(n_kv, (min(q0 + BQ, p.sq) - 1) / BKV + 1);

  for (int j = 0; j < n_kv; ++j) {
    const int c0 = j * BKV;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int c = i / D, d = i % D, col = c0 + c;
      Ks[c * LD + d] = col < p.skv ? k[col * p.ks.s + d] : 0.f;
    }
    for (int i = tid; i < BKV * DV; i += THREADS) {
      const int c = i / DV, d = i % DV, col = c0 + c;
      Vs[c * DV + d] = col < p.skv ? v[col * p.vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = c0 + tx + 16 * jj;
        const bool ok = col < p.skv && (!p.causal || row >= col);
        s[i][jj] = ok ? s[i][jj] * p.scale : NEG;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float pv = expf(s[i][jj] - m_new);
        Ps[(ty + 16 * i) * LP + tx + 16 * jj] = pv;
        rs += pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float pp[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pp[i] = Ps[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) vv[cc] = Vs[c * DV + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) acc[i][cc] = fmaf(pp[i], vv[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (p.lse != nullptr && tx == 0) p.lse[(long long)bh * p.sq + row] = m[i] + logf(den);
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) o[row * p.os.s + tx + 16 * cc] = acc[i][cc] / den;
  }
}

template <int D, int DV>
cudaError_t launch(const Params& p, int n_bh, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<D, DV>() * sizeof(float);
  static bool configured = false;  // the attribute is set once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(n_bh, (p.sq + BQ - 1) / BQ);
  flash_fwd_f32<D, DV><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace simt

template <bool BF16, int D, int DV>
cudaError_t run(const Params& p, int n_bh, cudaStream_t s) {
  return BF16 ? tc::launch<D, DV>(p, n_bh, s) : simt::launch<D, DV>(p, n_bh, s);
}

// the instantiated (D, DV) pairs; ops.py's HEAD_DIMS lists the same
template <bool BF16>
cudaError_t dispatch(const Params& p, int n_bh, int d, int dv, cudaStream_t s) {
  if (d == dv) {
    switch (d) {
      case 16: return run<BF16, 16, 16>(p, n_bh, s);
      case 32: return run<BF16, 32, 32>(p, n_bh, s);
      case 64: return run<BF16, 64, 64>(p, n_bh, s);
      case 128: return run<BF16, 128, 128>(p, n_bh, s);
      case 160: return run<BF16, 160, 160>(p, n_bh, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (d == 192 && dv == 128) return run<BF16, 192, 128>(p, n_bh, s);
  if (d == 64 && dv == 32) return run<BF16, 64, 32>(p, n_bh, s);
  return cudaErrorInvalidValue;
}

}  // namespace fa

// dtype: 0 = float32 (CUDA-core instance), 1 = bfloat16 (tensor-core
// instance; q, k and v 16-byte aligned with strides a multiple of 8).
// strides: (b, h, s) for q, k, v and o in elements, 12 values; the head dim
// has unit stride. D is q's and k's head dim, Dv v's and o's. lse: null, or
// float32 [B*Hq, Sq] for the rows' log-sum-exp.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                               int D, int Dv, int causal, int dtype, float scale,
                               const long long* strides, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  fa::Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.qs = {strides[0], strides[1], strides[2]};
  p.ks = {strides[3], strides[4], strides[5]};
  p.vs = {strides[6], strides[7], strides[8]};
  p.os = {strides[9], strides[10], strides[11]};
  p.hq = Hq;
  p.group = Hq / Hkv;
  p.sq = Sq;
  p.skv = Skv;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(fa::dispatch<false>(p, B * Hq, D, Dv, s));
  if (dtype == 1) return static_cast<int>(fa::dispatch<true>(p, B * Hq, D, Dv, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
