// Causal / sliding-window attention with an online softmax, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:87
// (flash_attention_bhsd; _flash_kernel at :33).  Semantics are those of
// _flash_kernel and of kernels/flash_attention/ref.py: q is scaled in
// float32 before q k^T, masks come from absolute positions (key j is seen
// by query i when j <= i and, with a window, j > i - window), a masked
// logit is -1e30, the running (m, l, acc) are float32, l is clamped at
// 1e-37 and the output is rounded once to q's dtype.  Inputs are bf16 or
// float32 and are widened to float32 as they are staged.
//
// Layout: the model's, q and o (B, S, H, D), k and v (B, T, KV, D), all
// contiguous.  Query head h reads kv head h / (H / KV) directly, so GQA
// needs no repeated copy of K and V.  Ragged edges are masked here: query
// rows past S are not written, key columns past T are masked and their
// K and V are staged as zeros.
//
// What bounds it on the card: operations.  At the yi-9b prefill (B 8,
// H 32, KV 4, S = T = 4096, D 128) one launch does 4 * B*H * D * S(S+1)/2
// = 1.1e12 multiply-adds and adds against 604 MB of q, k, v and o, so the
// bf16 tensor cores (989 TFLOP/s) would need 1.1 ms and the bytes 0.18 ms.
//
// Design: this is the first, simple kernel, on the float32 CUDA cores
// (67 TFLOP/s), as the TPU kernel computes in float32.  A block owns a
// tile of BQ = 64 queries of one (b, h) and walks the key tiles of BK = 64
// that its mask does not empty (kernel.py:48-53's skip rule on this tile
// size), heaviest query tiles first.  Shared memory holds q*scale and K
// transposed ([d][row]), V row-major and P transposed, all float32 (112 KB
// at D = 128, two blocks per SM).  Each of the 256 threads owns a 4x4
// block of S = q k^T and the same 4 rows x D/16 columns of acc in
// registers, so every shared-memory read is a float4 that feeds 16 or 32
// FMAs; row max and row sum are reduced across the 16 threads of a row by
// warp shuffles.  wgmma / mma.sync tiles with TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// max / sum over the 16 threads that share a row (one half of a warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S,
                           int Tk, int H, int KV, float scale, int window) {
  constexpr int NC = D / 64;                  // float4 column groups of acc
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][BQ]  q * scale
  float* Kt = Qt + D * BQ;                      // [D][BK]
  float* Vs = Kt + D * BK;                      // [BK][D]
  float* Pt = Vs + BK * D;                      // [BK][BQ]

  const int n_qt = (S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(KV) * D;
  const T* qb = q + (static_cast<size_t>(b) * S * H + h) * D;
  const T* kb = k + (static_cast<size_t>(b) * Tk * KV + kvh) * D;
  const T* vb = v + (static_cast<size_t>(b) * Tk * KV + kvh) * D;
  T* ob = o + (static_cast<size_t>(b) * S * H + h) * D;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;                    // rows ty*4 .. ty*4+3
  const int tx = tid & 15;                    // S cols tx*4.., acc cols c*64+tx*4..

  // stage q * scale, transposed; rows past S are zeros
  for (int i = tid; i < BQ * (D / 4); i += kThreads) {
    const int r = i % BQ;
    const int d4 = (i / BQ) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) x = load4(qb + (q0 + r) * q_row + d4);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      Qt[(d4 + e) * BQ + r] = __fmul_rn(comp(x, e), scale);
  }

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  // key tiles the mask does not empty: none past the last row of the
  // tile; with a window none wholly at or before q0 - window
  const int k_stop = min(Tk, q0 + BQ);
  const int k_first = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  for (int k0 = k_first; k0 < k_stop; k0 += BK) {
    __syncthreads();                          // previous tile fully consumed
    for (int i = tid; i < BK * (D / 4); i += kThreads) {
      const int j = i % BK;
      const int d4 = (i / BK) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + j < Tk) x = load4(kb + (k0 + j) * kv_row + d4);
#pragma unroll
      for (int e = 0; e < 4; ++e) Kt[(d4 + e) * BK + j] = comp(x, e);
    }
    for (int i = tid; i < BK * (D / 4); i += kThreads) {
      const int j = i / (D / 4);
      const int d4 = (i % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + j < Tk) x = load4(vb + (k0 + j) * kv_row + d4);
      store4(Vs + j * D + d4, x);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      const float4 a = load4(Qt + kk * BQ + ty * 4);
      const float4 bb = load4(Kt + kk * BK + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = __fmaf_rn(comp(a, i), comp(bb, j), s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        bool valid = col < Tk && col <= row;
        if (window > 0) valid = valid && col > row - window;
        if (!valid) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(__fsub_rn(m[i], m_new));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(__fsub_rn(s[i][j], m_new));
        sum = __fadd_rn(sum, p[i][j]);
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), row_sum(sum));
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store4(Pt + (tx * 4 + j) * BQ + ty * 4,
             make_float4(p[0][j], p[1][j], p[2][j], p[3][j]));
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pv = load4(Pt + kk * BQ + ty * 4);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = load4(Vs + kk * D + c * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][c * 4 + e] =
                __fmaf_rn(comp(pv, i), comp(vv, e), acc[i][c * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 out = make_float4(
          __fdiv_rn(acc[i][c * 4 + 0], denom), __fdiv_rn(acc[i][c * 4 + 1], denom),
          __fdiv_rn(acc[i][c * 4 + 2], denom), __fdiv_rn(acc[i][c * 4 + 3], denom));
      store4(ob + row * q_row + c * 64 + tx * 4, out);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tk, int H, int KV, float scale, int window,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (D * BQ + D * BK + BK * D + BK * BQ);
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, KV, scale,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window <= 0: no window.  D: 64 or 128.
// Returns cudaErrorInvalidValue for any other dtype or D.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype, int B,
                                     int S, int Tk, int H, int KV, int D,
                                     float scale, int window,
                                     cudaStream_t stream) {
  if (B <= 0 || S <= 0 || Tk <= 0) return 0;
  if (H <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, B, S, Tk, H, KV, scale, window,
                              stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, B, S, Tk, H, KV, scale, window,
                             stream);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, S, Tk, H, KV, scale,
                                      window, stream);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, S, Tk, H, KV, scale,
                                     window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
