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
// with float32 sums from inputs in q's dtype (bf16 or float32), the
// outputs rounded once to it.
//
// Layout: the model's, q, o, dO and dQ (B, S, H, D), k, v, dK and dV
// (B, T, KV, D), lse and Dl (B, H, S) float32, all contiguous and 16-byte
// aligned; D is 64 or 128; query head h reads kv head h / (H / KV), so GQA
// needs no repeated copy of K and V.
//
// What bounds it on the card: operations.  At the yi-9b training step (B
// 8, S = T = 2048, H 32, KV 4, D 128, causal) the five products are 2 S T
// D each per (b, h), halved by the mask: 6.9e11 operations, 0.6952 ms on
// the bf16 tensor cores (989 TFLOP/s) against 0.12 ms for the bytes.
//
// No atomics, so a gradient is the same bits on every run: dQ has its own
// pass, and dK / dV sum a kv head's H / KV query heads in a fixed order
// inside one block.  One C call launches two kernels on the stream, dq
// then dkdv; the dq kernel writes Dl, which dkdv reads.
//
// bf16 (tensor_core), FlashAttention-3's shape on the forward's pieces
// (csrc/hopper.cuh): each block is two consumer warpgroups of 64 rows (or
// keys) that share a ring of mbarrier-guarded stages in shared memory,
// filled by TMA (128-byte swizzle; the 4-D maps read GQA and ragged
// lengths in place, positions past the end come back as zeros).  Every
// product is `wgmma` with float32 sums in registers: the score products
// with both operands in shared memory, the accumulating products with P or
// dS as the A operand straight from registers (the accumulator layout of a
// score tile is the A fragment layout) and the other operand through the
// descriptor's transpose bit.  The scale multiplies S in float32 after the
// product, as in the forward.  Only tiles that an edge cuts are masked;
// tiles the mask empties are never visited, and the heaviest blocks run
// first.  There is no producer warp: each of an SM's four schedulers holds
// 16,384 registers, so with a ninth warp (three on one scheduler) ptxas
// allots at most 168 a thread, and dkdv's two accumulators alone take 128
// at D = 128; there it spilled and ptxas serialized its wgmma, setmaxnreg
// or not.  With the two warpgroups alone it may allot 255 (dkdv takes 241,
// dq 220, no spills).  Thread 0 issues every copy: a stage is refilled,
// kStages - 1 tiles ahead, as soon as both warpgroups are done with it.
//
//   dq (one block per kDqBQ = 128 query rows of a (b, h)): Q and dO once,
//   K and V tiles of kDqBK = 128 keys through a kDqStages-deep ring.
//   Before the loop each warpgroup sums its rows' Dl from o and dO in
//   device memory (a quarter of d a thread, in order, then across the
//   quad) while the first tiles land, and writes each row's lse and Dl to
//   a scratch padded to kRowPad rows.  A tile: S = Q K^T and dP = dO V^T,
//   P and dS in registers, dQ += dS K.  dQ is scaled and rounded once.
//
//   dkdv (one block per kKvBK = 128 keys of a (b, kv head)): K and V once,
//   then for the kv head's query heads in order, the query tiles of kKvBQ
//   = 64 rows that its mask leaves: Q and dO by TMA and the tile's lse and
//   Dl by bulk copies from the scratch, all on the stage's mbarrier,
//   through a kKvStages-deep ring.  A tile: S^T = K Q^T and dP^T = V dO^T,
//   P^T and dS^T in registers, dV += P^T dO, dK += dS^T Q; dK and dV are
//   rounded once.  64 query rows keep S^T, dP^T, dK and dV in registers
//   at D = 128 (128 rows would take 256 a thread for those four alone).
//
// P and dS are bf16 operands as two terms, hi = bf16(x) and lo = bf16(x -
// hi), two products with the same B tile (kPTerms, kDsTerms), so they keep
// ~16 significant bits.  Chosen by the card's readings (H100, with
// benchmarks/torch_kernel_variants.py `flash_bwd`, given the plain
// forward's O and lse), by the rule that chose the forward's P: the
// cheapest choice that keeps the card's bounds (2^-7 of each output's max
// |plain|, and 2e-2 + 2e-2 |x| elementwise) with margin.  dQ / dK / dV of
// max |plain|, two terms against one:
//   unit scale, 8 x 2048 x 32/4:  1.59e-3 / 3.97e-3 / 2.10e-3 against
//     3.18e-3 / 3.97e-3 / 4.20e-3;
//   q, k at 30x and v at 9x (yi's random-weight scale), the same shape:
//     3.13e-3 / 4.26e-3 / 3.01e-3 against 6.25e-3 / 4.26e-3 / 3.01e-3,
//     elementwise 5.9 / 4.0 / 0.50 times the bound against 119 / 25 / 0.83;
//   the same scale on the CPU emulation's inputs (2 x 2048 x 8/2):
//     3.68e-3 / 5.59e-3 / 4.44e-3 for both, elementwise 5.7 / 1.5 / 0.35
//     against 31 / 25 / 0.49.
// The readings come in bf16 steps of max |plain|'s binade: the 2^-7 bound
// admits one such step and never two.  At yi's scale dK takes one step
// whatever the terms: the tensor cores sum each k16 step of S exactly and
// truncate toward zero to float32, and at logits of ~1e3 that, not P or dS,
// moves dK's largest entries by a step (tests/test_torch_flash_attention.py
// emulates those sums, `wgmma_sum`, and reads the card's digits).  So the
// margin left there is none in dK for either choice; two terms keep dQ at
// half a step where one term takes a whole one (0.40 against 0.80 of the
// bound) and stay 5-20 times nearer the elementwise bound, which at that
// scale no design on the card meets (the card's checks run at the model's
// own inputs; at unit scale two terms read 0.19-0.31 of it, one term
// 0.38-0.67).  Two terms cost ~25% of the time (2.64
// against 2.03 ms).  So the design runs 10 products where the math needs
// 5: dq's pass recomputes S and dP (4 with dS's two terms), dkdv runs S^T,
// dP^T and two terms each of P^T dO and dS^T Q (6): 1.39 ms at the tensor
// cores' peak at the training shape.
//
// What the ring and the two warpgroups do about the bound: the ring keeps
// the next tiles' loads in flight while the warpgroups multiply, so no
// load waits in the loop once it is full; the two warpgroups share every
// tile in shared memory (one load feeds 128 rows of products), each issues
// its two score products back to back before one wait, and its
// accumulating products the same way, and the exponentials and bf16 splits
// of one run while the other's products occupy the tensor cores.
//
// float32 (cuda_core), the first design, on the float32 CUDA cores
// (67 TFLOP/s, 10 ms at best at the training shape), which keeps every sum
// in float32: dq (one block per 64 query rows of a (b, h)) computes its
// rows' Dl, then walks the key tiles its mask leaves accumulating dQ in
// registers; dkdv (one block per 64 keys of a (b, kv head)) walks the
// group's query heads in order and their query tiles.  Tiles are float32
// in shared memory (about 160 KB at D = 128, one block per SM); a thread
// owns 4 rows x 4 keys of S and dP (keys tx + 16 j, K and V rows
// XOR-swizzled by 16-byte chunk, chunk c of row r at c ^ (r & 7), so the
// 16 keys of a half-warp read 16 distinct bank quads) and 4 rows x D / 16
// columns of its accumulators.  Tiles are loaded synchronously.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace cuda_core {  // the float32 kernels

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

// four consecutive values of the float32 tensor
__device__ __forceinline__ float4 read4(const float* p) { return load4(p); }

__device__ __forceinline__ void write4(float* p, float4 v) { store4(p, v); }

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

}  // namespace cuda_core

namespace tensor_core {  // the bf16 kernels

using namespace hopper;

constexpr int kDqBQ = 128;      // dq: query rows of a block, 64 a consumer
constexpr int kDqBK = 128;      // dq: keys of a K / V tile
constexpr int kDqStages = 2;    // dq: K / V ring depth
constexpr int kKvBK = 128;      // dkdv: keys of a block, 64 a consumer
constexpr int kKvBQ = 64;       // dkdv: query rows of a Q / dO tile
constexpr int kKvStages = 2;    // dkdv: Q / dO ring depth
constexpr int kPTerms = 2;      // bf16 terms of P in dV = P^T dO
constexpr int kDsTerms = 2;     // bf16 terms of dS in dQ = dS K, dK = dS^T Q
constexpr int kRowPad = 128;    // the lse / Dl scratch pads S to this
static_assert(kRowPad % kDqBQ == 0 && kRowPad % kKvBQ == 0,
              "every row of a dq block and of a dkdv tile lies below S "
              "padded");
constexpr int kConsumers = 2;   // consumer warpgroups
constexpr int kThreads = 128 * kConsumers;  // no producer warp (see above)
constexpr float kLog2e = 1.4426950408889634f;

// bytes of one TMA box: `rows` positions x 64 bf16
__host__ __device__ constexpr uint32_t box_bytes(int rows) {
  return static_cast<uint32_t>(rows) * 128;
}

// Shared memory, from a 1024-byte boundary.  dq: Q, dO (kDqBQ rows),
// K[kDqStages], V[kDqStages] (kDqBK rows), each D / 64 boxes, then the
// mbarriers full[kDqStages], empty[kDqStages] and q.
template <int D>
constexpr size_t dq_smem() {
  return 1024 + (D / 64) * (2 * box_bytes(kDqBQ) +
                            2 * kDqStages * box_bytes(kDqBK)) +
         8 * (2 * kDqStages + 1);
}

// dkdv: K, V (kKvBK rows), Q[kKvStages], dO[kKvStages] (kKvBQ rows), each
// D / 64 boxes, then the stages' rows of lse and Dl (float32), then the
// mbarriers full[kKvStages], empty[kKvStages] and kv.
template <int D>
constexpr size_t dkdv_smem() {
  return 1024 + (D / 64) * (2 * box_bytes(kKvBK) +
                            2 * kKvStages * box_bytes(kKvBQ)) +
         kKvStages * 2 * kKvBQ * 4 + 8 * (2 * kKvStages + 1);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// (x, y) into entry i of kTerms bf16 A fragments: hi, and with two terms
// lo = bf16((x, y) - hi)
template <int kTerms, int N>
__device__ __forceinline__ void to_bf16(float x, float y,
                                        uint32_t (&f)[kTerms][N], int i) {
  if constexpr (kTerms == 2) split_bf16(x, y, f[0][i], f[1][i]);
  else f[0][i] = pack_bf16(x, y);
}

// k16 step kk of fragment term t: wgmma's four A registers
template <int kTerms, int N>
__device__ __forceinline__ void frag(const uint32_t (&f)[kTerms][N], int t,
                                     int kk, uint32_t (&a)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = f[t][4 * kk + j];
}

// One block: kDqBQ query rows of one (b, h), 64 a consumer warpgroup.
// Thread 0 issues every TMA load: Q and dO once, and each K / V tile
// kDqStages - 1 tiles ahead, into the slot of the tile both warpgroups have
// just finished.  Writes the rows' lse and Dl to `rows` ((B, H, 2, S padded
// to kRowPad) float32: lse, then Dl; 0 past S), then dQ.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                                  const __grid_constant__ CUtensorMap gmap,
                                  const __grid_constant__ CUtensorMap kmap,
                                  const __grid_constant__ CUtensorMap vmap,
                                  const __nv_bfloat16* __restrict__ o,
                                  const __nv_bfloat16* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  float* __restrict__ rows,
                                  __nv_bfloat16* __restrict__ dq, int S,
                                  int Tk, int H, int KV, float scale,
                                  int window) {
  constexpr int NB = D / 64;                   // 64-wide d boxes
  constexpr uint32_t kQBox = box_bytes(kDqBQ), kKBox = box_bytes(kDqBK);
  constexpr uint32_t kQTile = NB * kQBox, kKTile = NB * kKBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sG = sQ + kQTile;             // dO
  const uint32_t sK = sG + kQTile;
  const uint32_t sV = sK + kDqStages * kKTile;
  const uint32_t bars = sV + kDqStages * kKTile;
  const uint32_t q_bar = bars + 16 * kDqStages;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int n_qt = (S + kDqBQ - 1) / kDqBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * kDqBQ;
  // key tiles in which the mask leaves a pair: none past the block's last
  // row; with a window none wholly before k_min, the first key row q0 sees
  const int k_stop = min(Tk, min(S, q0 + kDqBQ));
  const int k_min = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_first = k_min / kDqBK * kDqBK;
  const int n_tiles =
      k_stop > k_min ? (k_stop - k_first + kDqBK - 1) / kDqBK : 0;

  // K and V tile i into stage i % kDqStages
  auto issue = [&](int i) {
    const int s = i % kDqStages;
    const uint32_t full = bars + 8 * s;
    const int k0 = k_first + i * kDqBK;
    mbar_expect_tx(full, 2 * kKTile);
    for (int x = 0; x < NB; ++x) {
      tma_load(sK + s * kKTile + x * kKBox, &kmap, full, 64 * x, kvh, k0, b);
      tma_load(sV + s * kKTile + x * kKBox, &vmap, full, 64 * x, kvh, k0, b);
    }
  };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(bars + 8 * s, 1);                               // full
      mbar_init(bars + 8 * (kDqStages + s), 128 * kConsumers);  // empty
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(q_bar, 2 * kQTile);
    for (int x = 0; x < NB; ++x) {
      tma_load(sQ + x * kQBox, &qmap, q_bar, 64 * x, h, q0, b);
      tma_load(sG + x * kQBox, &gmap, q_bar, 64 * x, h, q0, b);
    }
    for (int i = 0; i < min(kDqStages, n_tiles); ++i) issue(i);
  }
  __syncthreads();

  const int lane = tid & 31;
  const int g = lane >> 2;                  // row in an 8-row group
  const int tq = lane & 3;                  // column pair in an 8-column group
  const int r_lo = q0 + 64 * wg;            // this warpgroup's rows
  const int row = r_lo + 16 * ((tid & 127) >> 5) + g;  // and row + 8
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t bh_s = static_cast<size_t>(bh) * S;
  const int s_pad = (S + kRowPad - 1) / kRowPad * kRowPad;
  float* rg = rows + static_cast<size_t>(bh) * 2 * s_pad;

  // Dl = rowsum(dO o) and lse of rows row and row + 8 (0 past S), read
  // while the first tiles land: each thread of a quad sums a quarter of
  // d in order, then the quad adds the four sums (the same bits in each).
  // Both go to the (b, h)'s rows of the scratch, which dkdv copies from
  float dl[2], ls[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = row + 8 * j;
    float a = 0.f;
    if (r < S) {
      const size_t at = (static_cast<size_t>(b) * S + r) * q_row +
                        static_cast<size_t>(h) * D + tq * (D / 4);
      const uint4* op = reinterpret_cast<const uint4*>(o + at);
      const uint4* gp = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        const uint4 ov = op[c], gv = gp[c];
        const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
        const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = unpack_bf16(ow[e]), gf = unpack_bf16(gw[e]);
          a = __fmaf_rn(gf.x, of.x, a);
          a = __fmaf_rn(gf.y, of.y, a);
        }
      }
    }
    a = quad_sum(a);
    dl[j] = a;
    ls[j] = r < S ? lse[bh_s + r] : 0.f;
    if (tq == 0) {                          // r < S padded: every row
      rg[r] = ls[j];
      rg[s_pad + r] = a;
    }
  }

  float acc[D / 2];                         // dQ: rows row, row + 8
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_bar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kDqStages;
    const int k0 = k_first + it * kDqBK;
    const uint32_t kt = sK + s * kKTile, vt = sV + s * kKTile;
    // the slot of tile it - 1 takes tile it - 1 + kDqStages once both
    // warpgroups are done with it
    if (tid == 0 && it > 0 && it - 1 + kDqStages < n_tiles) {
      const int j = it - 1;
      mbar_wait(bars + 8 * (kDqStages + j % kDqStages), (j / kDqStages) & 1);
      issue(j + kDqStages);
    }
    __syncwarp();
    mbar_wait(bars + 8 * s, (it / kDqStages) & 1);

    // S = Q K^T and dP = dO V^T over D in steps of 16: a step is 32
    // bytes into a box
    float sc[kDqBK / 2], dp[kDqBK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qo = (kk / 4) * kQBox + (kk % 4) * 32 + wg * 64 * 128;
      const uint32_t ko = (kk / 4) * kKBox + (kk % 4) * 32;
      wgmma_ss<kDqBK>(sc, smem_desc(sQ + qo, 16, 1024),
                      smem_desc(kt + ko, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qo = (kk / 4) * kQBox + (kk % 4) * 32 + wg * 64 * 128;
      const uint32_t ko = (kk / 4) * kKBox + (kk % 4) * 32;
      wgmma_ss<kDqBK>(dp, smem_desc(sG + qo, 16, 1024),
                      smem_desc(vt + ko, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dp);

    // P = exp(scale S - lse), 0 where masked (only where an edge cuts);
    // dS = P (dP - Dl) as kDsTerms bf16 A fragments
    const bool edge = k0 + kDqBK - 1 > r_lo || k0 + kDqBK > Tk ||
                      (window > 0 && k0 <= r_lo + 63 - window);
    uint32_t df[kDsTerms][kDqBK / 4];
#pragma unroll
    for (int i = 0; i < kDqBK / 8; ++i) {
      float d4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e >> 1;               // row + 8 j
        float p = exp2f(__fmul_rn(
            __fsub_rn(__fmul_rn(sc[4 * i + e], scale), ls[j]), kLog2e));
        if (edge) {
          const int r = row + 8 * j;
          const int c = k0 + 8 * i + 2 * tq + (e & 1);
          bool valid = c < Tk && c <= r;
          if (window > 0) valid = valid && c > r - window;
          if (!valid) p = 0.f;
        }
        d4[e] = __fmul_rn(p, __fsub_rn(dp[4 * i + e], dl[j]));
      }
      to_bf16<kDsTerms>(d4[0], d4[1], df, 2 * i);
      to_bf16<kDsTerms>(d4[2], d4[3], df, 2 * i + 1);
    }

    // dQ += dS K over the tile's keys in steps of 16 (16 rows of K, 2 KB),
    // each term of dS with the same K rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqBK / 16; ++kk) {
      const uint64_t kd = smem_desc(kt + kk * 2048, kKBox, 1024);
#pragma unroll
      for (int t = 0; t < kDsTerms; ++t) {
        uint32_t a[4];
        frag(df, t, kk, a);
        wgmma_rs<D>(acc, a, kd);
      }
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
#pragma unroll
    for (int t = 0; t < kDsTerms; ++t) fence_regs(df[t]);
    mbar_arrive(bars + 8 * (kDqStages + s));
  }

  // dQ = scale (dS K), rounded once
  __nv_bfloat16* qb = dq + (static_cast<size_t>(b) * S * H + h) * D + 2 * tq;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (row < S)
      *reinterpret_cast<uint32_t*>(qb + row * q_row + 8 * i) =
          pack_bf16(__fmul_rn(acc[4 * i], scale),
                    __fmul_rn(acc[4 * i + 1], scale));
    if (row + 8 < S)
      *reinterpret_cast<uint32_t*>(qb + (row + 8) * q_row + 8 * i) =
          pack_bf16(__fmul_rn(acc[4 * i + 2], scale),
                    __fmul_rn(acc[4 * i + 3], scale));
  }
}

// One block: kKvBK keys of one (b, kv head), 64 a consumer warpgroup.
// Walks the kv head's H / KV query heads in order and, for each, the query
// tiles its mask leaves, accumulating dK and dV.  There is no producer
// warp: thread 0 issues every copy, K and V once, and each Q / dO tile
// with its rows of lse and Dl (bulk copies from the dq kernel's scratch)
// kKvStages - 1 tiles ahead, into the slot of the tile both warpgroups
// have just finished.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                                    const __grid_constant__ CUtensorMap gmap,
                                    const __grid_constant__ CUtensorMap kmap,
                                    const __grid_constant__ CUtensorMap vmap,
                                    const float* __restrict__ rows,
                                    __nv_bfloat16* __restrict__ dk,
                                    __nv_bfloat16* __restrict__ dv, int S,
                                    int Tk, int H, int KV, float scale,
                                    int window) {
  constexpr int NB = D / 64;
  constexpr uint32_t kKBox = box_bytes(kKvBK), kQBox = box_bytes(kKvBQ);
  constexpr uint32_t kKTile = NB * kKBox, kQTile = NB * kQBox;
  constexpr uint32_t kRowBytes = kKvBQ * 4;   // a tile's lse (or Dl)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_addr(smem_raw);
  const uint32_t sK = (base + 1023) & ~1023u;
  const uint32_t sV = sK + kKTile;
  const uint32_t sQ = sV + kKTile;
  const uint32_t sG = sQ + kKvStages * kQTile;            // dO
  const uint32_t sRows = sG + kKvStages * kQTile;         // lse, Dl a stage
  const uint32_t bars = sRows + kKvStages * 2 * kRowBytes;
  const uint32_t kv_bar = bars + 16 * kKvStages;
  const float* srows = reinterpret_cast<const float*>(smem_raw + (sRows - base));

  const int bkv = blockIdx.x;
  const int b = bkv / KV;
  const int kvh = bkv - b * KV;
  const int G = H / KV;
  const int k0 = static_cast<int>(blockIdx.y) * kKvBK;   // heaviest first
  const int s_pad = (S + kRowPad - 1) / kRowPad * kRowPad;
  // query tiles in which the mask leaves a pair: from the tile of row k0;
  // with a window, none at or past the last key + window
  const int q_begin = k0 / kKvBQ * kKvBQ;
  const int q_end = window > 0 ? min(S, min(Tk, k0 + kKvBK) - 1 + window) : S;
  const int n_q = q_end > q_begin ? (q_end - q_begin + kKvBQ - 1) / kKvBQ : 0;
  const int n_iters = G * n_q;

  // tile i of the walk (query head kvh G + i / n_q) into stage i % kKvStages
  auto issue = [&](int i) {
    const int s = i % kKvStages;
    const int g = i / n_q;
    const int q0 = q_begin + (i - g * n_q) * kKvBQ;
    const int h = kvh * G + g;
    const uint32_t full = bars + 8 * s;
    mbar_expect_tx(full, 2 * kQTile + 2 * kRowBytes);
    for (int x = 0; x < NB; ++x) {
      tma_load(sQ + s * kQTile + x * kQBox, &qmap, full, 64 * x, h, q0, b);
      tma_load(sG + s * kQTile + x * kQBox, &gmap, full, 64 * x, h, q0, b);
    }
    const float* src = rows + (static_cast<size_t>(b) * H + h) * 2 * s_pad + q0;
    bulk_load(sRows + s * 2 * kRowBytes, src, kRowBytes, full);
    bulk_load(sRows + s * 2 * kRowBytes + kRowBytes, src + s_pad, kRowBytes,
              full);
  };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(bars + 8 * s, 1);                               // full
      mbar_init(bars + 8 * (kKvStages + s), 128 * kConsumers);  // empty
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(kv_bar, 2 * kKTile);
    for (int x = 0; x < NB; ++x) {
      tma_load(sK + x * kKBox, &kmap, kv_bar, 64 * x, kvh, k0, b);
      tma_load(sV + x * kKBox, &vmap, kv_bar, 64 * x, kvh, k0, b);
    }
    for (int i = 0; i < min(kKvStages, n_iters); ++i) issue(i);
  }
  __syncthreads();

  const int lane = tid & 31;
  const int gr = lane >> 2;                   // row in an 8-row group
  const int tq = lane & 3;                    // column pair in an 8-column group
  const int k_lo = k0 + 64 * wg;              // this warpgroup's keys
  const int key = k_lo + 16 * ((tid & 127) >> 5) + gr;  // and key + 8
  float ak[D / 2], av[D / 2];                 // dK, dV: keys key, key + 8
#pragma unroll
  for (int i = 0; i < D / 2; ++i) ak[i] = av[i] = 0.f;
  mbar_wait(kv_bar, 0);

  for (int it = 0; it < n_iters; ++it) {
    const int s = it % kKvStages;
    const int g = it / n_q;
    const int q0 = q_begin + (it - g * n_q) * kKvBQ;
    const uint32_t qt = sQ + s * kQTile, gt = sG + s * kQTile;
    // the slot of tile it - 1 takes tile it - 1 + kKvStages once both
    // warpgroups are done with it
    if (tid == 0 && it > 0 && it - 1 + kKvStages < n_iters) {
      const int j = it - 1;
      mbar_wait(bars + 8 * (kKvStages + j % kKvStages), (j / kKvStages) & 1);
      issue(j + kKvStages);
    }
    __syncwarp();
    mbar_wait(bars + 8 * s, (it / kKvStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T over D in steps of 16
    float sc[kKvBQ / 2], dp[kKvBQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t ko = (kk / 4) * kKBox + (kk % 4) * 32 + wg * 64 * 128;
      const uint32_t qo = (kk / 4) * kQBox + (kk % 4) * 32;
      wgmma_ss<kKvBQ>(sc, smem_desc(sK + ko, 16, 1024),
                      smem_desc(qt + qo, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t ko = (kk / 4) * kKBox + (kk % 4) * 32 + wg * 64 * 128;
      const uint32_t qo = (kk / 4) * kQBox + (kk % 4) * 32;
      wgmma_ss<kKvBQ>(dp, smem_desc(sV + ko, 16, 1024),
                      smem_desc(gt + qo, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dp);

    // P^T = exp(scale S^T - lse), 0 where masked (only where an edge
    // cuts), dS^T = P^T (dP^T - Dl): the column's lse and Dl from the
    // stage; both as bf16 A fragments
    const float* rs = srows + s * 2 * kKvBQ;
    const bool edge = q0 < k_lo + 63 || k_lo + 64 > Tk || q0 + kKvBQ > S ||
                      (window > 0 && q0 + kKvBQ - 1 - k_lo >= window);
    uint32_t pf[kPTerms][kKvBQ / 4], df[kDsTerms][kKvBQ / 4];
#pragma unroll
    for (int i = 0; i < kKvBQ / 8; ++i) {
      const int c = 8 * i + 2 * tq;         // the tile's query c, c + 1
      const float2 l2 = *reinterpret_cast<const float2*>(rs + c);
      const float2 d2 = *reinterpret_cast<const float2*>(rs + kKvBQ + c);
      float p4[4], d4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = (e & 1) ? l2.y : l2.x;
        const float dl = (e & 1) ? d2.y : d2.x;
        float p = exp2f(__fmul_rn(
            __fsub_rn(__fmul_rn(sc[4 * i + e], scale), l), kLog2e));
        if (edge) {
          const int qr = q0 + c + (e & 1);
          const int kc = key + ((e & 2) ? 8 : 0);
          bool valid = kc < Tk && kc <= qr && qr < S;
          if (window > 0) valid = valid && kc > qr - window;
          if (!valid) p = 0.f;
        }
        p4[e] = p;
        d4[e] = __fmul_rn(p, __fsub_rn(dp[4 * i + e], dl));
      }
      to_bf16<kPTerms>(p4[0], p4[1], pf, 2 * i);
      to_bf16<kPTerms>(p4[2], p4[3], pf, 2 * i + 1);
      to_bf16<kDsTerms>(d4[0], d4[1], df, 2 * i);
      to_bf16<kDsTerms>(d4[2], d4[3], df, 2 * i + 1);
    }

    // dV += P^T dO and dK += dS^T Q over the tile's queries in steps of
    // 16 (16 rows of dO / Q, 2 KB), each term with the same rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKvBQ / 16; ++kk) {
      const uint64_t gd = smem_desc(gt + kk * 2048, kQBox, 1024);
      const uint64_t qd = smem_desc(qt + kk * 2048, kQBox, 1024);
#pragma unroll
      for (int t = 0; t < kPTerms; ++t) {
        uint32_t a[4];
        frag(pf, t, kk, a);
        wgmma_rs<D>(av, a, gd);
      }
#pragma unroll
      for (int t = 0; t < kDsTerms; ++t) {
        uint32_t a[4];
        frag(df, t, kk, a);
        wgmma_rs<D>(ak, a, qd);
      }
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(av);
    fence_regs(ak);
#pragma unroll
    for (int t = 0; t < kPTerms; ++t) fence_regs(pf[t]);
#pragma unroll
    for (int t = 0; t < kDsTerms; ++t) fence_regs(df[t]);
    mbar_arrive(bars + 8 * (kKvStages + s));
  }

  // dK = scale (dS^T Q) and dV, rounded once
  const size_t kv_row = static_cast<size_t>(KV) * D;
  const size_t at = (static_cast<size_t>(b) * Tk * KV + kvh) * D + 2 * tq;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kr = key + 8 * j;
      if (kr >= Tk) continue;
      const size_t x = at + kr * kv_row + 8 * i;
      *reinterpret_cast<uint32_t*>(dk + x) =
          pack_bf16(__fmul_rn(ak[4 * i + 2 * j], scale),
                    __fmul_rn(ak[4 * i + 2 * j + 1], scale));
      *reinterpret_cast<uint32_t*>(dv + x) =
          pack_bf16(av[4 * i + 2 * j], av[4 * i + 2 * j + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int S, int Tk, int H, int KV,
           float scale, int window, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // each kernel's maps, in its tiles' box heights
  CUtensorMap q_dq, g_dq, k_dq, v_dq, q_kv, g_kv, k_kv, v_kv;
  if (!make_map(&q_dq, encode, q, B, S, H, D, kDqBQ) ||
      !make_map(&g_dq, encode, dout, B, S, H, D, kDqBQ) ||
      !make_map(&k_dq, encode, k, B, Tk, KV, D, kDqBK) ||
      !make_map(&v_dq, encode, v, B, Tk, KV, D, kDqBK) ||
      !make_map(&q_kv, encode, q, B, S, H, D, kKvBQ) ||
      !make_map(&g_kv, encode, dout, B, S, H, D, kKvBQ) ||
      !make_map(&k_kv, encode, k, B, Tk, KV, D, kKvBK) ||
      !make_map(&v_kv, encode, v, B, Tk, KV, D, kKvBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (S + kDqBQ - 1) / kDqBQ;
  const int n_kt = (Tk + kKvBK - 1) / kKvBK;
  if (n_qt > 65535 || n_kt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto dq_kernel = flash_attention_bwd_dq_kernel<D>;
  auto dkdv_kernel = flash_attention_bwd_dkdv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem<D>()));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dkdv_smem<D>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* o_t = static_cast<const __nv_bfloat16*>(o);
  const auto* g_t = static_cast<const __nv_bfloat16*>(dout);
  dq_kernel<<<dim3(B * H, n_qt), kThreads, dq_smem<D>(), stream>>>(
      q_dq, g_dq, k_dq, v_dq, o_t, g_t, lse, delta,
      static_cast<__nv_bfloat16*>(dq), S, Tk, H, KV, scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<<<dim3(B * KV, n_kt), kThreads, dkdv_smem<D>(), stream>>>(
      q_kv, g_kv, k_kv, v_kv, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, Tk, H, KV, scale, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tensor_core

// The floats of the `delta` scratch that repro_flash_attention_bwd needs
// for (B, H, S): B H 2 S', S' = S rounded up to a multiple of kRowPad.
// The float32 kernels keep Dl there as (B, H, S), the bf16 ones lse and Dl
// as (B, H, 2, S').
extern "C" long long repro_flash_attention_bwd_scratch(int B, int H, int S) {
  const long long pad = tensor_core::kRowPad;
  return static_cast<long long>(B) * H * 2 * ((S + pad - 1) / pad * pad);
}

// dtype: 0 float32, 1 bfloat16.  window <= 0: no window.  D: 64 or 128.
// delta: float32 scratch of repro_flash_attention_bwd_scratch(B, H, S)
// floats.  Launches the dq kernel, then the dkdv kernel, on `stream`.
// Returns cudaErrorInvalidValue for any other dtype or D.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int S, int Tk, int H, int KV, int D,
    float scale, int window, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || Tk <= 0) return 0;
  if (H <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 128)
    return cuda_core::launch<float, 128>(q, k, v, o, dout, lse, delta, dq,
                                         dk, dv, B, S, Tk, H, KV, scale,
                                         window, stream);
  if (dtype == 0 && D == 64)
    return cuda_core::launch<float, 64>(q, k, v, o, dout, lse, delta, dq, dk,
                                        dv, B, S, Tk, H, KV, scale, window,
                                        stream);
  if (dtype == 1 && D == 128)
    return tensor_core::launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    B, S, Tk, H, KV, scale, window, stream);
  if (dtype == 1 && D == 64)
    return tensor_core::launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   B, S, Tk, H, KV, scale, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
