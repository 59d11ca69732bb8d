// Causal / sliding-window attention with an online softmax, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:87
// (flash_attention_bhsd; _flash_kernel at :33).  Semantics are those of
// _flash_kernel and of kernels/flash_attention/ref.py: q k^T is scaled in
// float32, masks come from absolute positions (key j is seen by query i
// when j <= i and, with a window, j > i - window), a masked logit is
// -1e30, the running (m, l, acc) are float32, l is clamped at 1e-37 and
// the output is rounded once to q's dtype.
//
// Layout: the model's, q and o (B, S, H, D), k and v (B, T, KV, D), all
// contiguous.  Query head h reads kv head h / (H / KV) directly, so GQA
// needs no repeated copy of K and V.  Ragged edges are masked here: query
// rows past S are not written, key columns past T are masked and their
// K and V are zeros.
//
// What bounds it on the card: operations.  At the yi-9b prefill (B 8,
// H 32, KV 4, S = T = 4096, D 128) one launch does 4 * B*H * D * S(S+1)/2
// = 1.1e12 multiply-adds and adds against 604 MB of q, k, v and o, so the
// bf16 tensor cores (989 TFLOP/s) would need 1.1 ms and the bytes 0.18 ms.
//
// Two kernels, chosen by dtype:
//
// bf16 (tensor_core::flash_attention_kernel), FlashAttention-3's shape.
// A block owns BQ = 128 queries of one (b, h) and has three warpgroups:
// two consumers of 64 query rows each, and a producer of which one thread
// issues TMA loads.  The Q tile is loaded once; K and V tiles of BK = 128
// keys come through a 2-stage ring in shared memory, each stage guarded by
// a "full" mbarrier (TMA bytes arrived) and an "empty" one (both
// consumers done), 160 KB at D = 128, one block per SM.  TMA reads the
// model's layout as a 4-D tensor (D, heads, positions, batch) in 64 x 128
// boxes with a 128-byte swizzle (a 128-wide head is two boxes), so GQA
// and ragged lengths cost no copies: positions past the end come back as
// zeros.  S = Q K^T is `wgmma` m64n128k16 with both operands in shared
// memory and float32 sums in registers; the scale is applied to S in
// float32 after the product (products of bf16 values are exact in
// float32, so the logits are the plain version's up to summation order;
// a bf16 q * scale would move logits of ~1e3 by units).  Only tiles that
// the causal diagonal, the window edge or the key end cut are masked;
// tiles the mask empties are skipped and the heaviest query tiles run
// first.  The online softmax keeps each row's max and sum in registers,
// in the accumulator's row layout, reduced across the 4 threads of a
// quad by shuffles.  P is `wgmma`'s A operand straight from registers
// (the accumulator layout of S is the A fragment layout of P), as two
// bf16 terms, hi = bf16(p) and lo = bf16(p - hi), so P V is two products
// with the same V tile and P keeps ~16 significant bits.  One bf16 P
// (FlashAttention's, and SDPA's flash backend's) errs by up to 2^-9 of
// |v| per term: on the yi-9b prefill's own inputs (|o| up to 49) that
// put outputs 0.25 off, outside 2e-2 + 2e-2 |o|.  V, (key, d) row-major,
// is the B operand through the descriptor's transpose bit.  Ping-pong
// scheduling of the two consumers (softmax of one under the other's
// wgmma) is later work.
//
// float32 (cuda_core::flash_attention_kernel), on the float32 CUDA cores
// (67 TFLOP/s), as the TPU kernel computes: tensor cores in float32 would
// mean TF32.  What bounds it is instruction throughput: an SM reads 32
// floats a clock from shared memory and runs 128 float32 FMAs, and one
// warp on a scheduler cannot keep the FMA pipe busy.  A block of 256 threads (8 warps, one
// block per SM) owns BQ = 128 queries of one (b, h) and walks the key
// tiles of BK = 64 that its mask does not empty (kernel.py:48-53's skip
// rule on this tile size), heaviest query tiles first; every tile is
// masked (masking only the tiles that an edge cuts ran slower).  Each
// thread owns 8 rows x 4 keys of S (keys tx + 16j) and the same 8 rows x
// D/16 columns of acc: in S = q k^T 8 q float4 (broadcast to the 16
// threads of a row group) and 4 k float4 feed 128 FMAs, in P V 2 p float4
// and D/64 v float4 feed 32 D/64.  A 64 x 128 block with 8 x 8 of S a
// thread reads 4 floats per FMA but fits only 4 warps on a SM, and ran
// slower (benchmarks/torch_kernel_variants.py, flash_f32).  Q (scaled
// once in place) and V sit row-major; K rows are XOR-swizzled by 16-byte
// chunk (chunk c of key r at c ^ (r & 7): conflict-free float4 reads of
// keys at stride 16); P is stored transposed in rows of BQ + 4 floats.
// K and V of tile t come by 16-byte cp.async into slot t & 1 of a 2-slot
// ring, started a whole tile ahead, so the copy runs under the previous
// tile's products; two barriers a tile (225 KB at D = 128).  Row max and
// row sum are reduced across the 16 threads of a row by warp shuffles.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cuda_core {  // the float32 kernel

constexpr int BQ = 128;             // queries of a block
constexpr int BK = 64;              // keys of a K / V tile
constexpr int kThreads = 2 * BQ;    // BQ / 8 row groups x 16 key groups
constexpr int KJ = BK / 16;         // keys of S a thread holds
constexpr int LDP = BQ + 4;         // floats per row of P^T in shared memory
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [r0, r0 + n) of one head of a (positions, heads, D) tensor into
// shared-memory rows of D floats, 16-byte chunk c of row r at chunk
// c ^ (r & 7) when SWIZZLE; rows at or past `end` are zeros.  No commit.
template <int D, bool SWIZZLE>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           size_t row_stride, int r0, int n,
                                           int end, int tid) {
  constexpr int C = D / 4;                    // 16-byte chunks of a row
  for (int i = tid; i < n * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const bool ok = r0 + r < end;
    cp_async16(dst + r * D + (SWIZZLE ? c ^ (r & 7) : c) * 4,
               ok ? src + static_cast<size_t>(r0 + r) * row_stride + c * 4
                  : src,
               ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int S, int Tk, int H, int KV, float scale,
                           int window) {
  constexpr int NC = D / 64;                  // float4 column groups of acc
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][D]  q * scale
  float* Ks = Qs + BQ * D;                      // 2 x [BK][D], swizzled
  float* Vs = Ks + 2 * BK * D;                  // 2 x [BK][D]
  float* Pt = Vs + 2 * BK * D;                  // [BK][LDP]  P transposed

  const int n_qt = (S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(KV) * D;
  const float* qb = q + (static_cast<size_t>(b) * S * H + h) * D;
  const float* kb = k + (static_cast<size_t>(b) * Tk * KV + kvh) * D;
  const float* vb = v + (static_cast<size_t>(b) * Tk * KV + kvh) * D;
  float* ob = o + (static_cast<size_t>(b) * S * H + h) * D;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;     // rows ty*8 .. ty*8+7 of S, P and acc
  const int tx = tid & 15;     // keys tx + 16j of S; acc cols c*64 + tx*4..
  const int sw = tx & 7;       // the swizzle of this thread's K rows

  // key tiles the mask does not empty: none past the last row of the
  // tile; with a window none wholly at or before q0 - window
  const int k_stop = min(Tk, q0 + BQ);
  const int k_first = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  // the ring: tile t's K and V go to slot t & 1 as one commit group,
  // started a whole tile ahead
  stage_rows<D, false>(Qs, qb, q_row, q0, BQ, S, tid);
  stage_rows<D, true>(Ks, kb, kv_row, k_first, BK, Tk, tid);
  stage_rows<D, false>(Vs, vb, kv_row, k_first, BK, Tk, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < BQ * D; i += kThreads) Qs[i] = __fmul_rn(Qs[i], scale);

  float m[8], l[8], acc[8][4 * NC];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_first, slot = 0; k0 < k_stop; k0 += BK, slot ^= 1) {
    // this tile's K and V landed and are visible, and every thread is done
    // with the last tile's P V: the other slot takes the next tile
    cp_async_wait<0>();
    __syncthreads();
    if (k0 + BK < k_stop) {
      stage_rows<D, true>(Ks + (slot ^ 1) * BK * D, kb, kv_row, k0 + BK, BK,
                          Tk, tid);
      stage_rows<D, false>(Vs + (slot ^ 1) * BK * D, vb, kv_row, k0 + BK, BK,
                           Tk, tid);
      cp_async_commit();
    }
    const float* Kt = Ks + slot * BK * D;
    const float* Vt = Vs + slot * BK * D;
    // S = (q * scale) k^T: per 4 columns of d, 8 q float4 and KJ k float4
    // feed 32 KJ FMAs; each s sums d in order
    float s[8][KJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d4 = 0; d4 < D; d4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = load4(Qs + (ty * 8 + i) * D + d4);
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float4 kk =
            load4(Kt + (tx + 16 * j) * D + (((d4 >> 2) ^ sw) << 2));
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[i][j] = __fmaf_rn(comp(a[i], e), comp(kk, e), s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + ty * 8 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int col = k0 + tx + 16 * j;
        bool valid = col < Tk && col <= row;
        if (window > 0) valid = valid && col > row - window;
        if (!valid) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(__fsub_rn(m[i], m_new));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        s[i][j] = expf(__fsub_rn(s[i][j], m_new));
        sum = __fadd_rn(sum, s[i][j]);
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), row_sum(sum));
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
      m[i] = m_new;
    }
    // P^T in rows of BQ + 4 floats: the 8 threads of a store phase (one
    // row group, 8 keys) write 8 distinct bank quads
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      float* dst = Pt + (tx + 16 * j) * LDP + ty * 8;
      store4(dst, make_float4(s[0][j], s[1][j], s[2][j], s[3][j]));
      store4(dst + 4, make_float4(s[4][j], s[5][j], s[6][j], s[7][j]));
    }
    __syncthreads();                          // P visible

    // acc += P V: per key 2 p float4 and NC v float4 feed 32 NC FMAs
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p0 = load4(Pt + kk * LDP + ty * 8);
      const float4 p1 = load4(Pt + kk * LDP + ty * 8 + 4);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = load4(Vt + kk * D + c * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float pi = i < 4 ? comp(p0, i) : comp(p1, i - 4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][c * 4 + e] = __fmaf_rn(pi, comp(vv, e), acc[i][c * 4 + e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + ty * 8 + i;
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

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tk, int H, int KV, float scale, int window,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * D + 4 * BK * D + BK * LDP);
  auto kernel = flash_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Tk, H, KV,
      scale, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cuda_core


namespace tensor_core {  // the bf16 kernel

constexpr int BQ = 128;         // query rows of a block: 64 per consumer
constexpr int BK = 128;         // keys of a K / V tile
constexpr int kStages = 2;      // K / V ring depth
constexpr int kConsumers = 2;   // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr uint32_t kBox = 128 * 128;  // one TMA box: 128 rows x 64 bf16
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// waits for the phase of `bar` with this parity to complete; a wait that
// outlasts any real one (2^24 polls, seconds) traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n == (1u << 24)) __trap();
  }
}

// one 64 x 128-row box of a (D, heads, positions, batch) tensor map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int head,
                                         int pos, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0),
         "r"(head), "r"(pos), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (the TMA maps' swizzle;
// every tile starts on a 1024-byte boundary, so the base offset is 0).
// lbo / sbo in bytes: K-major operands use only sbo, the 1024 bytes from
// one 8-row group to the next; the MN-major V uses lbo for the step from
// one 64-wide d box to the next.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from touching registers a wgmma still reads or
// writes before the wait that retires it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as two bf16 pairs with hi + lo = (x, y) to ~16 significant bits:
// hi rounds (x, y), lo rounds what hi left (exact in float32)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 r = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(x, r.x), __fsub_rn(y, r.y));
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// d (m64n128, float32) (+)= A (64 x 16, shared memory) B (16 x 128, shared
// memory), both K-major; scale_d == 0 ignores d's old value.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (m64n128, float32) += A (64 x 16 bf16, registers) B (16 x 128, shared
// memory, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n64, float32) += A (64 x 16 bf16, registers) B (16 x 64, shared
// memory, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 128) wgmma_rs_n128(o, a, b);
  else wgmma_rs_n64(o, a, b);
}

// Warpgroups 0 and 1 consume (64 query rows each), warpgroup 2 produces:
// one thread of it issues every TMA load.  Shared memory, from a
// 1024-byte boundary: Q (D/64 boxes), K[kStages], V[kStages] (D/64 boxes
// each), then the mbarriers full[kStages], empty[kStages] and q.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           __nv_bfloat16* __restrict__ o, int S, int Tk,
                           int H, int KV, float scale, int window) {
  constexpr int NB = D / 64;                  // 64-wide d boxes
  constexpr uint32_t kTile = NB * kBox;       // bytes of a Q, K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + kTile;
  const uint32_t sV = sK + kStages * kTile;
  const uint32_t bars = sV + kStages * kTile;
  const uint32_t q_bar = bars + 16 * kStages;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int n_qt = (S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * BQ;
  // key tiles the mask does not empty: none past the last row of the
  // block; with a window none wholly at or before q0 - window
  const int k_stop = min(Tk, q0 + BQ);
  const int k_first = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int n_tiles = k_stop > k_first ? (k_stop - k_first + BK - 1) / BK : 0;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                             // full
      mbar_init(bars + 8 * (kStages + s), 128 * kConsumers);  // empty
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: the Q tile once, then K and V tiles through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 128 * kConsumers) {
      mbar_expect_tx(q_bar, kTile);
      for (int x = 0; x < NB; ++x)
        tma_load(sQ + x * kBox, &qmap, q_bar, 64 * x, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t full = bars + 8 * s;
        mbar_wait(bars + 8 * (kStages + s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * kTile);
        const int k0 = k_first + i * BK;
        for (int x = 0; x < NB; ++x) {
          tma_load(sK + s * kTile + x * kBox, &kmap, full, 64 * x, kvh, k0, b);
          tma_load(sV + s * kTile + x * kBox, &vmap, full, 64 * x, kvh, k0, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int lane = tid & 31;
    const int g = lane >> 2;                  // row in an 8-row group
    const int tq = lane & 3;                  // column pair in an 8-column group
    const int r_lo = q0 + 64 * wg;            // this warpgroup's rows
    const int row = r_lo + 16 * ((tid & 127) >> 5) + g;  // and row + 8
    float acc[D / 2];                         // O: rows row, row + 8
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    mbar_wait(q_bar, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int k0 = k_first + it * BK;
      mbar_wait(bars + 8 * s, (it / kStages) & 1);

      // S = Q K^T over D in steps of 16: a step is 32 bytes into a box
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_ss_n128(sc, smem_desc(sQ + off + wg * 64 * 128, 16, 1024),
                      smem_desc(sK + s * kTile + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);

      // scale in float32 after the product; mask only where an edge cuts
      const bool edge = k0 + BK - 1 > r_lo || k0 + BK > Tk ||
                        (window > 0 && k0 <= r_lo + 63 - window);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = __fmul_rn(sc[i], scale);
      if (edge) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int r = row + ((i & 2) ? 8 : 0);
          const int c = k0 + 8 * (i / 4) + 2 * tq + (i & 1);
          bool valid = c < Tk && c <= r;
          if (window > 0) valid = valid && c > r - window;
          if (!valid) sc[i] = kNegInf;
        }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float a0 = exp2f(__fmul_rn(__fsub_rn(m0, mn0), kLog2e));
      const float a1 = exp2f(__fmul_rn(__fsub_rn(m1, mn1), kLog2e));
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t ph[BK / 4], pl[BK / 4];        // P = hi + lo: wgmma's A fragments
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const float p0 = exp2f(__fmul_rn(__fsub_rn(sc[4 * i], mn0), kLog2e));
        const float p1 =
            exp2f(__fmul_rn(__fsub_rn(sc[4 * i + 1], mn0), kLog2e));
        const float p2 =
            exp2f(__fmul_rn(__fsub_rn(sc[4 * i + 2], mn1), kLog2e));
        const float p3 =
            exp2f(__fmul_rn(__fsub_rn(sc[4 * i + 3], mn1), kLog2e));
        sum0 = __fadd_rn(sum0, __fadd_rn(p0, p1));
        sum1 = __fadd_rn(sum1, __fadd_rn(p2, p3));
        split_bf16(p0, p1, ph[2 * i], pl[2 * i]);
        split_bf16(p2, p3, ph[2 * i + 1], pl[2 * i + 1]);
      }
      l0 = __fadd_rn(__fmul_rn(l0, a0), quad_sum(sum0));
      l1 = __fadd_rn(__fmul_rn(l1, a1), quad_sum(sum1));
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[4 * i] = __fmul_rn(acc[4 * i], a0);
        acc[4 * i + 1] = __fmul_rn(acc[4 * i + 1], a0);
        acc[4 * i + 2] = __fmul_rn(acc[4 * i + 2], a1);
        acc[4 * i + 3] = __fmul_rn(acc[4 * i + 3], a1);
      }

      // O += P_hi V + P_lo V over the tile's keys in steps of 16 (16 rows
      // of V, 2 KB)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t vd = smem_desc(sV + s * kTile + kk * 2048, kBox, 1024);
        const uint32_t hi[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                                ph[4 * kk + 3]};
        const uint32_t lo[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                                pl[4 * kk + 3]};
        wgmma_pv<D>(acc, hi, vd);
        wgmma_pv<D>(acc, lo, vd);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      mbar_arrive(bars + 8 * (kStages + s));
    }

    const float d0 = fmaxf(l0, 1e-37f), d1 = fmaxf(l1, 1e-37f);
    const size_t q_row = static_cast<size_t>(H) * D;
    __nv_bfloat16* ob = o + (static_cast<size_t>(b) * S * H + h) * D + 2 * tq;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      if (row < S)
        *reinterpret_cast<uint32_t*>(ob + row * q_row + 8 * i) =
            pack_bf16(__fdiv_rn(acc[4 * i], d0), __fdiv_rn(acc[4 * i + 1], d0));
      if (row + 8 < S)
        *reinterpret_cast<uint32_t*>(ob + (row + 8) * q_row + 8 * i) =
            pack_bf16(__fdiv_rn(acc[4 * i + 2], d1),
                      __fdiv_rn(acc[4 * i + 3], d1));
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function: it is fetched through the
// runtime, so the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, T, heads, D) bf16, contiguous, as a 4-D map (D, heads, T, B) with
// 64 x 1 x 128 x 1 boxes: positions past T come back as zeros
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* base, int B,
              int T, int heads, int D) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * D;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * T};
  const cuuint32_t box[4] = {64, 1, 128, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tk, int H, int KV, float scale, int window,
           cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, encode, q, B, S, H, D) ||
      !make_map(&kmap, encode, k, B, Tk, KV, D) ||
      !make_map(&vmap, encode, v, B, Tk, KV, D))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem =
      1024 + (1 + 2 * kStages) * (D / 64) * kBox + 8 * (2 * kStages + 1);
  auto kernel = flash_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (S + BQ - 1) / BQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(B * H, n_qt);                     // heaviest query tiles first
  kernel<<<grid, kThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), S, Tk, H, KV, scale,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tensor_core

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
    return cuda_core::launch<128>(q, k, v, o, B, S, Tk, H, KV, scale,
                                         window, stream);
  if (dtype == 0 && D == 64)
    return cuda_core::launch<64>(q, k, v, o, B, S, Tk, H, KV, scale,
                                        window, stream);
  if (dtype == 1 && D == 128)
    return tensor_core::launch<128>(q, k, v, o, B, S, Tk, H, KV, scale,
                                    window, stream);
  if (dtype == 1 && D == 64)
    return tensor_core::launch<64>(q, k, v, o, B, S, Tk, H, KV, scale, window,
                                   stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
