// The backward of causal / sliding-window flash attention, for Hopper.
//
// The backward of row 7 of the kernel table: csrc/flash_attention.cu,
// which replaces src/repro/kernels/flash_attention/kernel.py:87.  The
// reference has no backward kernel: it trains through JAX's autodiff of
// the plain _mha_streaming (src/repro/models/attention.py:104).  Given q,
// k, v, the forward's output o, its cotangent dO and each row's
// log-sum-exp lse (written by the forward when asked), with the forward's
// masks (key j is seen by query i when j <= i and, with a window,
// j > i - window):
//   P  = exp(scale q k^T - lse)          recomputed tile by tile
//   Dl = rowsum(dO o)                     one value per query row
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - Dl)
//   dQ = scale dS K,  dK = scale dS^T Q
// all in float32 from inputs in q's dtype (bf16 or float32), the outputs
// rounded once to it.
//
// Layout: the model's, q, o, dO and dQ (B, S, H, D), k, v, dK and dV
// (B, T, KV, D), lse and Dl (B, H, S) float32, all contiguous and 16-byte
// aligned; D is 64 or 128; query head h reads kv head h / (H / KV).
//
// What bounds it on the card: operations.  At the yi-9b training step (B
// 8, S = T = 2048, H 32, KV 4, D 128, causal) the five products are 2 S T
// D each per (b, h), halved by the mask: 6.9e11 operations, 0.69 ms on the
// bf16 tensor cores (989 TFLOP/s) against 0.12 ms for the bytes.  This
// first design runs them on the float32 CUDA cores (67 TFLOP/s, 10 ms at
// best), which keeps every sum in float32 and the code plain; mma on the
// tensor cores is later work.
//
// No atomics, so a gradient is the same bits on every run.  Two kernels:
// dq (one block per 64 query rows of a (b, h)) first computes its rows' Dl
// into a (B, H, S) buffer, then walks the key tiles its mask leaves
// (heaviest query tiles first) accumulating dQ in registers.  dkdv (one
// block per 64 keys of a (b, kv head)) then walks the H / KV query heads
// of the group in order and, for each, the query tiles its mask leaves,
// accumulating dK and dV in registers: the group's sum comes in a fixed
// order inside the block.  Each block holds its tiles in shared memory as
// float32 (about 160 KB at D = 128, one block per SM); a thread owns 4
// rows x 4 keys of S and dP (keys tx + 16 j, K and V rows XOR-swizzled by
// 16-byte chunk, chunk c of row r at c ^ (r & 7), so the 16 keys of a
// half-warp read 16 distinct bank quads) and 4 rows x D / 16 columns of its
// accumulators.  Tiles are loaded synchronously: no copy overlaps the
// products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace flash_bwd {

constexpr int BQ = 64;              // query rows of a tile
constexpr int BK = 64;              // keys of a tile
constexpr int kThreads = 256;       // 16 row groups x 16 key groups
constexpr int LDS = BK + 4;         // floats per row of P, dS (and of dS^T)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// four consecutive values of a float32 or bf16 tensor as float32
__device__ __forceinline__ float4 read4(const float* p) { return load4(p); }

__device__ __forceinline__ float4 read4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void write4(float* p, float4 v) { store4(p, v); }

__device__ __forceinline__ void write4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// rows [r0, r0 + n) of one head of a (positions, heads, D) tensor into
// shared rows of D floats, chunk c of row r at c ^ (r & 7) when SWIZZLE;
// rows at or past `end` are zeros
template <typename T, int D, bool SWIZZLE>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          size_t row_stride, int r0, int n,
                                          int end) {
  constexpr int C = D / 4;
  for (int i = threadIdx.x; i < n * C; i += kThreads) {
    const int r = i / C, c = i % C;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < end) x = read4(src + static_cast<size_t>(r0 + r) * row_stride
                                + c * 4);
    store4(dst + r * D + (SWIZZLE ? c ^ (r & 7) : c) * 4, x);
  }
}

// s = A B^T and t = C E^T over D for the thread's rows ty * 4 + i and keys
// tx + 16 j: A, C plain [BQ][D], B, E swizzled [BK][D]; each sum runs over
// d in order
template <int D>
__device__ __forceinline__ void two_scores(const float* A, const float* B,
                                           const float* C, const float* E,
                                           float (&s)[4][4],
                                           float (&t)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 2
  for (int d4 = 0; d4 < D; d4 += 4) {
    const int col = (((d4 >> 2) ^ (tx & 7)) << 2);
    float4 a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = load4(A + (ty * 4 + i) * D + d4);
      c[i] = load4(C + (ty * 4 + i) * D + d4);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 b = load4(B + (tx + 16 * j) * D + col);
      const float4 e = load4(E + (tx + 16 * j) * D + col);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          s[i][j] = __fmaf_rn(comp(a[i], x), comp(b, x), s[i][j]);
          t[i][j] = __fmaf_rn(comp(c[i], x), comp(e, x), t[i][j]);
        }
    }
  }
}

__device__ __forceinline__ bool visible(int row, int col, int S, int Tk,
                                        int window) {
  bool ok = row < S && col < Tk && col <= row;
  if (window > 0) ok = ok && col > row - window;
  return ok;
}

// P and dS of the thread's 4 x 4 (rows q0 + ty * 4 + i, keys k0 + tx + 16 j)
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      const float* lse_s, const float* dl_s,
                                      int q0, int k0, int S, int Tk,
                                      float scale, int window) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = visible(q0 + r, k0 + tx + 16 * j, S, Tk, window);
      const float p =
          ok ? expf(__fsub_rn(__fmul_rn(s[i][j], scale), lse_s[r])) : 0.f;
      s[i][j] = p;
      dp[i][j] = __fmul_rn(p, __fsub_rn(dp[i][j], dl_s[r]));
    }
  }
}

// One block: BQ query rows of one (b, h).  Computes their Dl (written to
// `delta`), then dQ.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dq_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k,
                                  const T* __restrict__ v,
                                  const T* __restrict__ o,
                                  const T* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  float* __restrict__ delta,
                                  T* __restrict__ dq, int S, int Tk, int H,
                                  int KV, float scale, int window) {
  constexpr int NC = D / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [BQ][D]
  float* dOs = Qs + BQ * D;                      // [BQ][D]
  float* Ks = dOs + BQ * D;                      // [BK][D] swizzled
  float* Vs = Ks + BK * D;                       // [BK][D] swizzled
  float* dSt = Vs + BK * D;                      // [BK][LDS]: dS^T
  float* lse_s = dSt + BK * LDS;                 // [BQ]
  float* dl_s = lse_s + BQ;                      // [BQ]

  const int tid = threadIdx.x;
  const int n_qt = (S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(KV) * D;
  const size_t q_off = (static_cast<size_t>(b) * S * H + h) * D;
  const size_t kv_off = (static_cast<size_t>(b) * Tk * KV + kvh) * D;

  load_rows<T, D, false>(Qs, q + q_off, q_row, q0, BQ, S);
  load_rows<T, D, false>(dOs, dout + q_off, q_row, q0, BQ, S);
  __syncthreads();
  {
    // Dl of row tid / 4: four quarters of d in order, then summed across
    // the four threads (the same bits in each)
    const int r = tid >> 2, part = tid & 3;
    float acc = 0.f;
    if (q0 + r < S) {
      const T* orow = o + q_off + static_cast<size_t>(q0 + r) * q_row;
#pragma unroll 4
      for (int d = part * (D / 4); d < (part + 1) * (D / 4); d += 4) {
        const float4 a = read4(orow + d);
        const float4 g = load4(dOs + r * D + d);
#pragma unroll
        for (int x = 0; x < 4; ++x)
          acc = __fmaf_rn(comp(g, x), comp(a, x), acc);
      }
    }
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 2));
    if (part == 0) {
      dl_s[r] = acc;
      lse_s[r] = q0 + r < S ? lse[static_cast<size_t>(bh) * S + q0 + r] : 0.f;
      if (q0 + r < S) delta[static_cast<size_t>(bh) * S + q0 + r] = acc;
    }
  }

  const int qr = tid >> 4, qc = tid & 15;   // dQ rows qr * 4 + i, columns
  float acc[4][4 * NC];                     // qc * 4 + 64 c + e
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;

  const int k_stop = min(Tk, q0 + BQ);
  const int k_first = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  for (int k0 = k_first; k0 < k_stop; k0 += BK) {
    __syncthreads();            // the last tile's dS^T and K are read
    load_rows<T, D, true>(Ks, k + kv_off, kv_row, k0, BK, Tk);
    load_rows<T, D, true>(Vs, v + kv_off, kv_row, k0, BK, Tk);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_scores<D>(Qs, Ks, dOs, Vs, s, dp);
    probs(s, dp, lse_s, dl_s, q0, k0, S, Tk, scale, window);
    {
      const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store4(dSt + (tx + 16 * j) * LDS + ty * 4,
               make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]));
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 ds = load4(dSt + j * LDS + qr * 4);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int chunk = (c * 64 + qc * 4) >> 2;
        const float4 kk = load4(Ks + j * D + ((chunk ^ (j & 7)) << 2));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][c * 4 + e] =
                __fmaf_rn(comp(ds, i), comp(kk, e), acc[i][c * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + qr * 4 + i;
    if (row >= S) continue;
    T* dst = dq + q_off + static_cast<size_t>(row) * q_row;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      write4(dst + c * 64 + qc * 4,
             make_float4(__fmul_rn(acc[i][c * 4 + 0], scale),
                         __fmul_rn(acc[i][c * 4 + 1], scale),
                         __fmul_rn(acc[i][c * 4 + 2], scale),
                         __fmul_rn(acc[i][c * 4 + 3], scale)));
  }
}

// One block: BK keys of one (b, kv head).  Walks the kv head's H / KV
// query heads in order and their query tiles, accumulating dK and dV.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dkdv_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const T* __restrict__ dout,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta,
                                    T* __restrict__ dk, T* __restrict__ dv,
                                    int S, int Tk, int H, int KV, float scale,
                                    int window) {
  constexpr int NC = D / 64;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [BK][D] swizzled
  float* Vs = Ks + BK * D;                       // [BK][D] swizzled
  float* Qs = Vs + BK * D;                       // [BQ][D]
  float* dOs = Qs + BQ * D;                      // [BQ][D]
  float* Ps = dOs + BQ * D;                      // [BQ][LDS]
  float* dSs = Ps + BQ * LDS;                    // [BQ][LDS]
  float* lse_s = dSs + BQ * LDS;                 // [BQ]
  float* dl_s = lse_s + BQ;                      // [BQ]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const int bkv = blockIdx.y;
  const int b = bkv / KV;
  const int kvh = bkv - b * KV;
  const int G = H / KV;
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(KV) * D;
  const size_t kv_off = (static_cast<size_t>(b) * Tk * KV + kvh) * D;

  load_rows<T, D, true>(Ks, k + kv_off, kv_row, k0, BK, Tk);
  load_rows<T, D, true>(Vs, v + kv_off, kv_row, k0, BK, Tk);

  const int kr = tid >> 4, kc = tid & 15;   // keys kr * 4 + j, columns
  float ak[4][4 * NC], av[4][4 * NC];       // kc * 4 + 64 c + e
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) ak[j][c] = av[j][c] = 0.f;

  // query tiles that see a key of this block: rows >= k0 and, with a
  // window, rows < k0 + BK - 1 + window
  const int q_begin = k0 / BQ * BQ;
  const int q_end = window > 0 ? min(S, k0 + BK - 1 + window) : S;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t bh = static_cast<size_t>(b) * H + h;
    const size_t q_off = (static_cast<size_t>(b) * S * H + h) * D;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();          // the last tile's Q, dO, P and dS are read
      load_rows<T, D, false>(Qs, q + q_off, q_row, q0, BQ, S);
      load_rows<T, D, false>(dOs, dout + q_off, q_row, q0, BQ, S);
      if (tid < BQ) {
        const bool in = q0 + tid < S;
        lse_s[tid] = in ? lse[bh * S + q0 + tid] : 0.f;
        dl_s[tid] = in ? delta[bh * S + q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      two_scores<D>(Qs, Ks, dOs, Vs, s, dp);
      probs(s, dp, lse_s, dl_s, q0, k0, S, Tk, scale, window);
      {
        const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            Ps[(ty * 4 + i) * LDS + tx + 16 * j] = s[i][j];
            dSs[(ty * 4 + i) * LDS + tx + 16 * j] = dp[i][j];
          }
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        const float4 p = load4(Ps + i * LDS + kr * 4);
        const float4 ds = load4(dSs + i * LDS + kr * 4);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 go = load4(dOs + i * D + c * 64 + kc * 4);
          const float4 qq = load4(Qs + i * D + c * 64 + kc * 4);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              av[j][c * 4 + e] =
                  __fmaf_rn(comp(p, j), comp(go, e), av[j][c * 4 + e]);
              ak[j][c * 4 + e] =
                  __fmaf_rn(comp(ds, j), comp(qq, e), ak[j][c * 4 + e]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + kr * 4 + j;
    if (key >= Tk) continue;
    const size_t at = kv_off + static_cast<size_t>(key) * kv_row;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      write4(dk + at + c * 64 + kc * 4,
             make_float4(__fmul_rn(ak[j][c * 4 + 0], scale),
                         __fmul_rn(ak[j][c * 4 + 1], scale),
                         __fmul_rn(ak[j][c * 4 + 2], scale),
                         __fmul_rn(ak[j][c * 4 + 3], scale)));
      write4(dv + at + c * 64 + kc * 4,
             make_float4(av[j][c * 4 + 0], av[j][c * 4 + 1],
                         av[j][c * 4 + 2], av[j][c * 4 + 3]));
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int S, int Tk, int H, int KV,
           float scale, int window, cudaStream_t stream) {
  const size_t smem_dq =
      sizeof(float) * (2 * BQ * D + 2 * BK * D + BK * LDS + 2 * BQ);
  const size_t smem_dkdv =
      sizeof(float) * (2 * BK * D + 2 * BQ * D + 2 * BQ * LDS + 2 * BQ);
  auto dq_kernel = flash_attention_bwd_dq_kernel<T, D>;
  auto dkdv_kernel = flash_attention_bwd_dkdv_kernel<T, D>;
  cudaError_t err = allow_smem(dq_kernel, smem_dq);
  if (err == cudaSuccess) err = allow_smem(dkdv_kernel, smem_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  dq_kernel<<<dim3((S + BQ - 1) / BQ, B * H), kThreads, smem_dq, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, lse, delta,
      static_cast<T*>(dq), S, Tk, H, KV, scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<<<dim3((Tk + BK - 1) / BK, B * KV), kThreads, smem_dkdv,
                stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
                          static_cast<T*>(dv), S, Tk, H, KV, scale, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_bwd

// dtype: 0 float32, 1 bfloat16.  window <= 0: no window.  D: 64 or 128.
// delta: (B, H, S) float32 scratch (Dl).  Launches the dq kernel, then the
// dkdv kernel, on `stream`.  Returns cudaErrorInvalidValue for any other
// dtype or D.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int S, int Tk, int H, int KV, int D,
    float scale, int window, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || Tk <= 0) return 0;
  if (H <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 128)
    return flash_bwd::launch<float, 128>(q, k, v, o, dout, lse, delta, dq, dk,
                                         dv, B, S, Tk, H, KV, scale, window,
                                         stream);
  if (dtype == 0 && D == 64)
    return flash_bwd::launch<float, 64>(q, k, v, o, dout, lse, delta, dq, dk,
                                        dv, B, S, Tk, H, KV, scale, window,
                                        stream);
  if (dtype == 1 && D == 128)
    return flash_bwd::launch<__nv_bfloat16, 128>(q, k, v, o, dout, lse, delta,
                                                 dq, dk, dv, B, S, Tk, H, KV,
                                                 scale, window, stream);
  if (dtype == 1 && D == 64)
    return flash_bwd::launch<__nv_bfloat16, 64>(q, k, v, o, dout, lse, delta,
                                                dq, dk, dv, B, S, Tk, H, KV,
                                                scale, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
