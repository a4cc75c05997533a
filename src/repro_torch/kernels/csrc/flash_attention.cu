// flash_attention: prefill attention with an online softmax over KV blocks.
// o[b,h,i,:] = softmax_j(q[b,h,i,:] . k[b,h/G,j,:] * scale) @ v[b,h/G,:,:]
// with key padding (j < Skv) and, if causal, the top-left mask i >= j.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, body _flash_kernel) and the jnp twin the model
// runs, src/repro/models/layers.py::jnp_flash_attention.
//
// Bound on the H100: operations. At the model's prefill shape (B 4, S 2048,
// 32 query heads over 8 KV heads, D 64, causal) the work is 68.7 GFLOP
// against 84 MB of q, k, v and o, about 800 FLOP per byte. This first
// design computes in f32 FMA (no tensor cores), so its own ceiling is the
// 67 TFLOP/s f32 rate rather than the 989 TFLOP/s bf16 tensor-core rate the
// bound is stated against; f32 math keeps the 2e-4 bar of the f32 path.
// Measured at that shape it reaches about a third of the f32 FMA rate: the
// inner loops make one shared-memory load per two FMAs (PERF.md).
//
// Design. One 256-thread block per (b*Hq + h, 64-row q tile); b*Hq + h is
// the grid's x (no 65535 limit), and the grid's y walks the tiles from the
// last to the first, so the long causal tiles start first. The q tile is
// staged once in shared memory as f32; each 64-key K/V tile after it.
// S = Q K^T is a 64x64 register-tiled product: thread (ty, tx) owns rows
// ty + 16*i and cols tx + 16*j (i, j < 4), so the 16 threads of one row
// sit in one half-warp and the row max and row sum are xor-shuffles. P
// goes through shared memory into O += P V, where the thread owns rows
// ty + 16*i and D/16 columns tx + 16*c. Rows padded to D + 1 floats keep
// the column reads of a warp on distinct banks. The running max m, sum l
// and the accumulator stay in registers; o = acc / max(l, 1e-30) is stored
// once in the input type.
//
// Differences from the TPU version: the KV head h / G is read in place
// (no repeat copy), strides over B, H and S are arguments (unit stride on
// D), ragged S is masked on load and on store (no padding copies), and KV
// tiles that the causal mask covers entirely are skipped. That skip is
// exact: once the first tile has set m, such a tile's p = exp(-1e30 - m)
// is 0 and its alpha is 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fa {

constexpr int BQ = 64, BKV = 64, THREADS = 256;
constexpr float NEG = -1e30f;

struct Strides { long long b, h, s; };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides qs, ks, vs, os;
  int hq, group, sq, skv, causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd(Params p) {
  constexpr int LD = D + 1, LP = BKV + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][LD]
  float* Ks = Qs + BQ * LD;     // [BKV][LD]
  float* Vs = Ks + BKV * LD;    // [BKV][D]
  float* Ps = Vs + BKV * D;     // [BQ][LP]

  const int tile = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  const int q0 = tile * BQ;
  const T* q = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
  const T* k = static_cast<const T*>(p.k) + b * p.ks.b + hk * p.ks.h;
  const T* v = static_cast<const T*>(p.v) + b * p.vs.b + hk * p.vs.h;
  T* o = static_cast<T*>(p.o) + b * p.os.b + h * p.os.h;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D, row = q0 + r;
    Qs[r * LD + d] = row < p.sq ? to_f32(q[row * p.qs.s + d]) : 0.f;
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
      const bool in = col < p.skv;
      Ks[c * LD + d] = in ? to_f32(k[col * p.ks.s + d]) : 0.f;
      Vs[c * D + d] = in ? to_f32(v[col * p.vs.s + d]) : 0.f;
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
      for (int cc = 0; cc < DC; ++cc) vv[cc] = Vs[c * D + tx + 16 * cc];
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
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
      o[row * p.os.s + tx + 16 * cc] = from_f32<T>(acc[i][cc] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int n_bh, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<D>() * sizeof(float);
  static bool configured = false;  // the attribute is set once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(n_bh, (p.sq + BQ - 1) / BQ);
  flash_fwd<T, D><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int n_bh, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, n_bh, stream);
    case 32: return launch<T, 32>(p, n_bh, stream);
    case 64: return launch<T, 64>(p, n_bh, stream);
    case 128: return launch<T, 128>(p, n_bh, stream);
    case 160: return launch<T, 160>(p, n_bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fa

// dtype: 0 = float32, 1 = bfloat16. strides: (b, h, s) for q, k, v and o in
// elements, 12 values; D has unit stride.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                               int D, int causal, int dtype, float scale,
                               const long long* strides, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  fa::Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
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
  if (dtype == 0) return static_cast<int>(fa::dispatch<float>(p, B * Hq, D, s));
  if (dtype == 1) return static_cast<int>(fa::dispatch<__nv_bfloat16>(p, B * Hq, D, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
