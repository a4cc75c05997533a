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
// 3.35 TB/s.
//
// Design. B*Hkv = 32 blocks would leave most of the 132 SMs idle, so the
// cache is cut into chunks of `chunk` slots: pass 1 runs one 128-thread
// block per (b*Hkv + h, chunk), pass 2 merges the chunks' partials with
// ref.merge_partials's math (skipped when there is one chunk). A block
// whose chunk lies past the filled length writes an empty partial (m =
// -1e30, l = 0) without reading the cache; in the merge its weight is
// exp(-1e30 - m) = 0. The filled length is read on the device from
// `kv_len` (an int32), so a decode step needs no host sync; a null
// pointer means `kv_len_host`.
// Inside a chunk: D/8 lanes hold one slot's row as 16-byte loads (8
// values each), a warp covers 32/(D/8 rounded up to a power of two) slots
// per step. Pass A forms the G scores of each slot (dot over the lanes'
// 8 values, xor-shuffle sum) into shared memory; pass B takes each row's
// max and exp and sum over the chunk (one warp per query); pass C adds
// p * v into G x 8 register accumulators per lane, which are summed over
// the warp's slot groups by shuffles and over the 4 warps in shared
// memory. The cache is read in the model's [B, S, Hkv, D] layout through
// strides (unit stride on D, 16-byte aligned rows). Each warp keeps one
// 16-byte load in flight per step of its slot loop, so at the model's
// shape the loop is bound by load latency rather than bytes (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace fdk {

constexpr int THREADS = 128, WARPS = 4, GMAX = 8, VEC = 8, MAX_CHUNK = 256;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  float* acc;  // this pass's outputs: partials per chunk, or the result
  float* m;
  float* l;
  const int* len_dev;
  int len_host, H, G, S, chunk;
  long long qb, qh, qg, kb, kh, ks, vb, vh, vs;
  float scale;
};

template <int D>
struct Layout {
  static constexpr int LPS = D / VEC;  // lanes holding one slot's row
  static constexpr int LANES = LPS <= 1 ? 1 : LPS <= 2 ? 2 : LPS <= 4 ? 4
                             : LPS <= 8 ? 8 : LPS <= 16 ? 16 : 32;
  static constexpr int SPW = 32 / LANES;  // slots per warp per step
  static constexpr int SPB = SPW * WARPS;  // slots per block per step
  static_assert(D % VEC == 0 && LPS <= 32, "head dim");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load8(const float* p, float (&x)[VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ int filled(const Params& p) {
  return min(p.len_dev ? *p.len_dev : p.len_host, p.S);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) decode_chunk(Params p) {
  using L = Layout<D>;
  __shared__ float qs[GMAX][D];
  __shared__ float sc[GMAX][MAX_CHUNK];
  __shared__ float red[WARPS][GMAX][D];

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int s0 = blockIdx.y * p.chunk, e = min(s0 + p.chunk, filled(p));
  const size_t part = (size_t)blockIdx.y * gridDim.x + bh;
  float* acc_o = p.acc + part * p.G * D;
  float* m_o = p.m + part * p.G;
  float* l_o = p.l + part * p.G;
  const int tid = threadIdx.x;
  if (s0 >= e) {  // past the filled length: an empty partial
    for (int i = tid; i < p.G * D; i += THREADS) acc_o[i] = 0.f;
    if (tid < p.G) {
      m_o[tid] = NEG;
      l_o[tid] = 0.f;
    }
    return;
  }

  const T* q = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* k = static_cast<const T*>(p.k) + b * p.kb + h * p.kh;
  const T* v = static_cast<const T*>(p.v) + b * p.vb + h * p.vh;
  for (int i = tid; i < p.G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    qs[g][d] = to_f32(q[g * p.qg + d]);
  }
  const int warp = tid / 32, lane = tid % 32;
  const int grp = lane / L::LANES, gl = lane % L::LANES, d0 = gl * VEC;
  const bool active = gl < L::LPS;
  __syncthreads();

  // A: scores s_j = q . k_j * scale of the chunk's slots
  for (int base = s0; base < e; base += L::SPB) {
    const int slot = base + warp * L::SPW + grp;
    float kf[VEC];
    if (active && slot < e) {
      load8(k + slot * p.ks + d0, kf);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) kf[i] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= p.G) break;
      float s = 0.f;
      if (active) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) s = fmaf(qs[g][d0 + i], kf[i], s);
      }
#pragma unroll
      for (int off = L::LANES / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(FULL, s, off);
      if (gl == 0 && slot < e) sc[g][slot - s0] = s * p.scale;
    }
  }
  __syncthreads();

  // B: per query, the chunk's max m, p_j = exp(s_j - m) in place, l
  const int len = e - s0;
  for (int g = warp; g < p.G; g += WARPS) {
    float mx = NEG;
    for (int i = lane; i < len; i += 32) mx = fmaxf(mx, sc[g][i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    float sum = 0.f;
    for (int i = lane; i < len; i += 32) {
      const float pj = expf(sc[g][i] - mx);
      sc[g][i] = pj;
      sum += pj;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
    if (lane == 0) {
      m_o[g] = mx;
      l_o[g] = sum;
    }
  }
  __syncthreads();

  // C: acc = sum_j p_j v_j
  float a[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i) a[g][i] = 0.f;
  for (int base = s0; base < e; base += L::SPB) {
    const int slot = base + warp * L::SPW + grp;
    if (active && slot < e) {
      float vf[VEC];
      load8(v + slot * p.vs + d0, vf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= p.G) break;
        const float pg = sc[g][slot - s0];
#pragma unroll
        for (int i = 0; i < VEC; ++i) a[g][i] = fmaf(pg, vf[i], a[g][i]);
      }
    }
  }
#pragma unroll
  for (int off = L::LANES; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= p.G) break;
#pragma unroll
      for (int i = 0; i < VEC; ++i) a[g][i] += __shfl_xor_sync(FULL, a[g][i], off);
    }
  }
  if (grp == 0 && active) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= p.G) break;
#pragma unroll
      for (int i = 0; i < VEC; ++i) red[warp][g][d0 + i] = a[g][i];
    }
  }
  __syncthreads();
  for (int i = tid; i < p.G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][g][d];
    acc_o[i] = s;
  }
}

// pass 2: merge the chunks' partials of one (b, h) into the result
__global__ void __launch_bounds__(THREADS)
decode_merge(Params p, const float* acc_p, const float* m_p, const float* l_p,
             int n_split, int D) {
  const int bh = blockIdx.x, n_bh = gridDim.x, G = p.G;
  const int n_used = min(n_split, (filled(p) + p.chunk - 1) / p.chunk);
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D;
    float mx = NEG;
    for (int sp = 0; sp < n_used; ++sp)
      mx = fmaxf(mx, m_p[((size_t)sp * n_bh + bh) * G + g]);
    float num = 0.f, den = 0.f;
    for (int sp = 0; sp < n_used; ++sp) {
      const size_t part = (size_t)sp * n_bh + bh;
      const float w = expf(m_p[part * G + g] - mx);
      num = fmaf(acc_p[part * G * D + i], w, num);
      den = fmaf(l_p[part * G + g], w, den);
    }
    p.acc[(size_t)bh * G * D + i] = num;
    if (i % D == 0) {
      p.m[(size_t)bh * G + g] = mx;
      p.l[(size_t)bh * G + g] = den;
    }
  }
}

template <typename T>
cudaError_t launch_chunks(const Params& p, dim3 grid, int d, cudaStream_t s) {
  switch (d) {
    case 16: decode_chunk<T, 16><<<grid, THREADS, 0, s>>>(p); break;
    case 32: decode_chunk<T, 32><<<grid, THREADS, 0, s>>>(p); break;
    case 64: decode_chunk<T, 64><<<grid, THREADS, 0, s>>>(p); break;
    case 128: decode_chunk<T, 128><<<grid, THREADS, 0, s>>>(p); break;
    case 160: decode_chunk<T, 160><<<grid, THREADS, 0, s>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace fdk

// dtype: 0 = float32, 1 = bfloat16. q is [B, H, G, D] and k, v are
// [B, H, S, D] through strides (b, h, g|s) in elements, 9 values; D has
// unit stride. acc [B*H, G, D], m and l [B*H, G] are float32. With
// n_split = ceil(S / chunk) > 1 the *_part buffers hold n_split times as
// much for pass 1.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            float* acc, float* m, float* l, float* acc_part,
                            float* m_part, float* l_part, const int* kv_len,
                            int kv_len_host, int B, int H, int G, int S, int D,
                            int chunk, int n_split, int dtype, float scale,
                            const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || G > fdk::GMAX || S <= 0 || chunk <= 0 ||
      chunk > fdk::MAX_CHUNK || n_split != (S + chunk - 1) / chunk ||
      (n_split > 1 && !(acc_part && m_part && l_part)))
    return static_cast<int>(cudaErrorInvalidValue);
  fdk::Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.len_dev = kv_len;
  p.len_host = kv_len_host;
  p.H = H;
  p.G = G;
  p.S = S;
  p.chunk = chunk;
  p.qb = strides[0]; p.qh = strides[1]; p.qg = strides[2];
  p.kb = strides[3]; p.kh = strides[4]; p.ks = strides[5];
  p.vb = strides[6]; p.vh = strides[7]; p.vs = strides[8];
  p.scale = scale;
  const bool split = n_split > 1;
  p.acc = split ? acc_part : acc;
  p.m = split ? m_part : m;
  p.l = split ? l_part : l;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * H, n_split);
  cudaError_t err = dtype == 0 ? fdk::launch_chunks<float>(p, grid, D, s)
                  : dtype == 1 ? fdk::launch_chunks<__nv_bfloat16>(p, grid, D, s)
                               : cudaErrorInvalidValue;
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  fdk::Params out = p;
  out.acc = acc;
  out.m = m;
  out.l = l;
  fdk::decode_merge<<<B * H, fdk::THREADS, 0, s>>>(out, acc_part, m_part, l_part,
                                                   n_split, D);
  return static_cast<int>(cudaGetLastError());
}
