// The backward of the RWKV6 WKV recurrence from the zero state, for Hopper:
// the chunked form, a head's channels split over a thread-block cluster.
//
// The backward of row 8 of the kernel table: csrc/rwkv_scan.cu, which
// replaces src/repro/kernels/rwkv_scan/kernel.py:85.  The reference has no
// backward kernel: it trains through JAX's autodiff of the lax.scan of
// _wkv_step (src/repro/models/ssm.py:116-124).  Per head, with S_0 = 0,
//   out_t     = r_t . (S_t + diag(u) k_t v_t^T)
//   S_{t+1}   = diag(w_t) S_t + k_t v_t^T
// so, walking t backward from dS_T = 0 (the final state's cotangent is
// zero on the training path: the wrapper refuses any other),
//   e_t       = v_t . dout_t
//   dr_t      = S_t dout_t + u k_t e_t
//   dk_t      = dS_{t+1} v_t + r_t u e_t
//   dv_t      = dS_{t+1}^T k_t + (sum_k r_t u k_t) dout_t
//   dw_t      = rowsum(dS_{t+1} * S_t)
//   du       += r_t k_t e_t              (over b and t)
//   dS_t      = diag(w_t) dS_{t+1} + r_t dout_t^T
// in float32.
//
// Layout: the model's, r, k, v, w, dout and dr, dk, dv, dw (B, T, H, 64),
// u and du (H, 64), all float32, contiguous and 16-byte aligned.
//
// What bounds it on the card: the arithmetic of the function.  At the
// rwkv6-7b training step (B 8, T 2048, H 64) the reverse recurrence does 14
// float32 operations per state entry and step, 6.0e10 in all (0.90 ms on
// the CUDA cores at 67 TFLOP/s); the five inputs and four outputs are
// 2.4 GB (0.72 ms at 3.35 TB/s).  This design adds its own scratch, the
// states at chunk starts, 1.07 GB written and read (0.64 ms more traffic).
//
// Design.  State rows are independent in both recurrences (row c of S and
// of dS needs only channel c of w, k and r), so a head's 64 channels are
// split over a cluster of kSplit CTAs, kCh channels each; only dv (a sum
// over channels) crosses them.  T is cut into chunks of L = kChunk steps.
// A first kernel carries each CTA's rows of S chunk by chunk (as the
// forward does: S' = diag(A_L) S + (k Bs)^T v on the tensor cores) and
// writes them at every chunk start to a scratch buffer; it needs few
// registers and little shared memory, so six CTAs an SM keep its copies in
// flight.  The second walks the chunks in reverse, carrying dS.  Per chunk,
// with S_0 its start state, dS_L the cotangent at its end, A_t =
// prod_{m<t} w_m, Bs_t = prod_{m>t} w_m, D_ti = prod_{i<m<t} w_m and a_ti =
// D_ti k_i (i < t), every decay a product of w's in the linear domain (w =
// 0 stays an exact zero, nothing divides by w):
//   X = S_0 dout^T, Y = dS_L v^T, G = v dout^T      (K- or V-long products)
//   W_it = v_i . dS_{t+1},  W_i,L-1 = Y_i,  W_i,t-1 = w_t W_it + r_t G_it
//   U_t = S_0 . dS_{t+1},   U_L-1 = rowsum(S_0 dS_L), U_t-1 = w_t U_t + r_t X_t
//   dr_t = A_t X_t + sum_{i<t} a_ti G_it + u k_t e_t
//   dk_t = W_tt + r_t u e_t
//   dw_t = A_t U_t + sum_{i<t} a_ti W_it            (rowsum(dS_{t+1} S_t))
//   dv   = (k Bs) dS_L + P^T dout,
//          P_ti = sum_k r_t a_ti (i < t), P_tt = sum_k r_t u k_t
//   dS_0 = diag(A_L) dS_L + (r A)^T dout
// The states never appear step by step: a channel's S_t lies in the span
// of S_0 and the chunk's v_i, its dS_{t+1} in that of dS_L and the dout_j,
// so their row products are sums over the chunk's L coefficients.  The five
// products (X, Y, G, dv and the dS carry) run on the tensor cores as 3xTF32
// mma.sync m16n8k8 (csrc/tf32_mma.cuh).  The per-channel sums over the
// chunk are FMAs on eight lanes a channel, lane j taking the slots i = j
// and j + 8: it walks W_i backward and a_.i forward (slot j + 8 only over
// t >= 8, since a_ti = 0 for t <= i), sums its two slots' p_t = a_ti W_it
// and q_t = a_ti G_it, and the sums over the channel's lanes close by a
// halving butterfly that leaves lane j with steps j and j + 8; the scores'
// sum over channels goes by shuffles within a warp, then through shared
// memory in warp order.  Instruction issue, not the tensor cores or the
// bytes, bounds this design on the card, so these sums are laid out for
// the fewest instructions.  Warp w's share of a CTA's dv partial is
// columns 16 w .., which CTA rank w owns: it goes there by st.async into
// the owner's receive buffer, completing on the owner's mbarrier, and the
// owner sums the cluster's partials in rank order a chunk later.  A relaxed
// cluster barrier a chunk orders only the buffers' reuse (a release there
// would wait for every outstanding store and copy).  du comes as
// per-(b, h) partials that a third kernel sums over b in order.  No
// atomics: every gradient is the same bits on every run.  The next chunk's
// r, k, w, v and dout arrive by cp.async into a second stage while the CTA
// computes; padded shared rows keep the fragment loads free of bank
// conflicts where the pattern allows.  A ragged last chunk is padded with
// r = k = v = dout = 0 and w = 1.

#include <cuda_runtime.h>

#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace {

using tf32::a_frag;
using tf32::cp_async16;
using tf32::mma3;

constexpr int kHead = 64;           // K = V
constexpr int kChunk = 16;          // L: time steps per chunk
constexpr int kSplit = 4;           // CTAs of a cluster: one head
constexpr int kCh = kHead / kSplit; // channels a CTA
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;       // CTAs per SM the shared memory allows
// padded shared rows (floats); "4" rows serve fragments read as
// stride * g + q, "8" rows those read as stride * q + g
constexpr int kWRow = kHead + 4;    // v, dout, S_0, dS
constexpr int kSRow = kCh;          // the CTA's r, k, w columns
constexpr int kGRow = kChunk + 4;   // G, rows read as float4s
constexpr int kKbRow = kCh + 4;     // k Bs (dv's A operand)
constexpr int kRaRow = kCh + 8;     // r A (the carry's A operand, transposed)
constexpr int kStage = 3 * kChunk * kSRow + 2 * kChunk * kWRow;
constexpr int kSmemFloats =
    2 * kStage                      // r, k, w, v, dout: two stages
    + 2 * kCh * kWRow               // S_0, dS
    + 2 * kCh * kChunk              // X, Y
    + kChunk * kGRow                // G
    + kChunk * kCh                  // A
    + kChunk * kKbRow + kChunk * kRaRow
    + kWarps * kChunk * kChunk      // scores, per warp
    + 2 * kSplit * kChunk * kCh     // dv partials received, two buffers
    + 3 * kChunk * kCh              // dr, dk, dw of the chunk
    + 3 * kCh                       // A_L, rowsum(S_0 dS_L), u
    + 4;                            // two mbarriers

static_assert(kChunk == 16 && kCh == 16 && kThreads == 128,
              "the mma tiles: 16 steps and 16 channels a CTA, 4 warps of 16 "
              "columns; a channel's 16 slots on 8 lanes, 4 channels a warp");
static_assert(kHead % kSplit == 0 && kSplit <= 8, "a portable cluster");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

// an arrival that orders nothing (no fence: a release here would wait for
// every outstanding global store and copy)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// the address of p's counterpart in the shared memory of cluster CTA rank
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(hopper::smem_addr(p)), "r"(rank));
  return a;
}

// two floats into a cluster CTA's shared memory, completing on its mbarrier
__device__ __forceinline__ void st_async2(uint32_t a, float x, float y,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
      "[%0], {%1, %2}, [%3];\n"
      :: "r"(a), "f"(x), "f"(y), "r"(bar) : "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct Stage {
  float* r;   // [kChunk][kSRow]: the CTA's channels
  float* k;
  float* w;
  float* v;   // [kChunk][kWRow]: every column
  float* g;   // dout
};

__device__ __forceinline__ Stage stage_at(float* base) {
  Stage s;
  s.r = base;
  s.k = s.r + kChunk * kSRow;
  s.w = s.k + kChunk * kSRow;
  s.v = s.w + kChunk * kSRow;
  s.g = s.v + kChunk * kWRow;
  return s;
}

// A thread's fixed share of a chunk's copies, as offsets from the chunk's
// first row: threads below kSliceCopies one float4 of each kCh-column
// tile (row ts, column cs; also the outputs' and dv's stores), every
// thread two of each 64-column tile (rows tw and tw + 8, column cw).
constexpr int kSliceCopies = kChunk * (kCh / 4);
static_assert(kSliceCopies <= kThreads &&
                  kChunk * (kHead / 4) == 2 * kThreads,
              "the copy shares");

struct Share {
  int ts, cs, tw, cw;
  size_t gs, gw;      // global offsets: ts row + c0 + cs, tw row + cw
};

__device__ __forceinline__ Share share_of(size_t row, int c0) {
  Share x;
  const int tid = threadIdx.x;
  x.ts = tid / (kCh / 4);
  x.cs = 4 * (tid % (kCh / 4));
  x.tw = tid / (kHead / 4);
  x.cw = 4 * (tid % (kHead / 4));
  x.gs = x.ts * row + c0 + x.cs;
  x.gw = x.tw * row + x.cw;
  return x;
}

// Issue the copies of n steps (rows) at `at` into a stage: the CTA's kCh
// columns of k and w (and r), all of v (and dout); rows past n are r = k =
// v = dout = 0, w = 1 (no contribution, no decay).  `all` false copies
// only k, w and v (the first pass).
__device__ __forceinline__ void load_stage(
    const Stage& s, const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ w, const float* __restrict__ v,
    const float* __restrict__ dout, size_t at, size_t row, int n, bool all,
    const Share& x) {
  if (threadIdx.x < kSliceCopies) {
    const int o = x.ts * kSRow + x.cs;
    if (x.ts < n) {
      cp_async16(s.k + o, k + at + x.gs);
      cp_async16(s.w + o, w + at + x.gs);
      if (all) cp_async16(s.r + o, r + at + x.gs);
    } else {
      *reinterpret_cast<float4*>(s.k + o) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(s.w + o) = make_float4(1.f, 1.f, 1.f, 1.f);
      *reinterpret_cast<float4*>(s.r + o) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = x.tw + h * kChunk / 2;
    const int o = t * kWRow + x.cw;
    const size_t g = at + x.gw + h * (kChunk / 2) * row;
    if (t < n) {
      cp_async16(s.v + o, v + g);
      if (all) cp_async16(s.g + o, dout + g);
    } else {
      *reinterpret_cast<float4*>(s.v + o) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(s.g + o) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// the CTA's kCh rows of a chunk-start state (kCh x 64, contiguous) into S_s
__device__ __forceinline__ void load_state(float* S_s, const float* src,
                                           const Share& x) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = x.tw + h * kCh / 2;
    cp_async16(S_s + c * kWRow + x.cw, src + c * kHead + x.cw);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// A state's rows (kCh x 64) as C fragments: warp wi holds columns
// 16 wi .. 16 wi + 15, st[4 nt + e] at (g, 16 wi + 8 nt + 2 q), (g, .. + 1),
// (g + 8, ..), (g + 8, .. + 1).  Scale each row by al[row], then add
// A^T B over the chunk: A^T's element (row, t) at at_s[t * kRaRow + row],
// B the chunk's [t][64] rows at b_s.
__device__ __forceinline__ void carry(float (&st)[8], const float* at_s,
                                      const float* b_s, const float* al) {
  const int wi = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const float a0 = al[g], a8 = al[g + 8];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    st[4 * nt + 0] *= a0;
    st[4 * nt + 1] *= a0;
    st[4 * nt + 2] *= a8;
    st[4 * nt + 3] *= a8;
  }
  unsigned ah[4], al4[4];
#pragma unroll
  for (int i0 = 0; i0 < kChunk; i0 += 8) {
    a_frag<true>(at_s, kRaRow, 0, i0, ah, al4);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float (&c)[4] = *reinterpret_cast<float(*)[4]>(st + 4 * nt);
      mma3(c, ah, al4, b_s, kWRow, i0, 16 * wi + 8 * nt);
    }
  }
}

// st's C fragments to rows [kCh][stride] at dst (global or shared)
__device__ __forceinline__ void store_rows(const float (&st)[8], float* dst,
                                           int stride) {
  const int wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = 16 * wi + 8 * nt + 2 * q;
    *reinterpret_cast<float2*>(dst + g * stride + col) =
        make_float2(st[4 * nt], st[4 * nt + 1]);
    *reinterpret_cast<float2*>(dst + (g + 8) * stride + col) =
        make_float2(st[4 * nt + 2], st[4 * nt + 3]);
  }
}

// out (16 x 16) = A B^T over 64 columns, A [16][kWRow] rows, B [16][kWRow]
// rows (the mma's B read transposed), on 3xTF32.
__device__ __forceinline__ void gram(float (&o)[2][4], const float* a_s,
                                     const float* b_s) {
  unsigned ah[4], al[4];
  float o2[2][4];             // odd k steps: two chains of half the length
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = o2[nt][e] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < kHead; k0 += 16) {
    a_frag<false>(a_s, kWRow, 0, k0, ah, al);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) mma3<true>(o[nt], ah, al, b_s, kWRow, k0,
                                              8 * nt);
    a_frag<false>(a_s, kWRow, 0, k0 + 8, ah, al);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) mma3<true>(o2[nt], ah, al, b_s, kWRow,
                                              k0 + 8, 8 * nt);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] += o2[nt][e];
}

__device__ __forceinline__ void store_tile(const float (&o)[2][4], float* dst,
                                           int stride) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = 8 * nt + 2 * q;
    dst[g * stride + col] = o[nt][0];
    dst[g * stride + col + 1] = o[nt][1];
    dst[(g + 8) * stride + col] = o[nt][2];
    dst[(g + 8) * stride + col + 1] = o[nt][3];
  }
}

// The CTA's share of one chunk's dv (row ts, columns cs .. of its kCh):
// the cluster's kSplit partials that arrived in buf, summed in rank order
__device__ __forceinline__ float4 partials_sum(const float* buf,
                                               const Share& x) {
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int y = 0; y < kSplit; ++y) {
    const float4 p = ld4(buf + (y * kChunk + x.ts) * kCh + x.cs);
    sum.x += p.x;
    sum.y += p.y;
    sum.z += p.z;
    sum.w += p.w;
  }
  return sum;
}

// The first pass: the CTA's kCh rows of S at every chunk start, carried
// chunk by chunk on the tensor cores, to ckpt (one CTA a (b, h, channel
// group)).  It moves bytes and does little arithmetic: a ring of
// kStatesStages chunks of k, w and v keeps the next chunk's copies in
// flight, and few registers and little shared memory let kStatesBlocks
// CTAs share an SM.  Every chunk it carries is whole (the last is never
// carried).
constexpr int kStatesBlocks = 8;
constexpr int kStatesStages = 2;
constexpr int kStage1 = 2 * kChunk * kSRow + kChunk * kWRow;   // k, w, v
constexpr int kStatesSmemFloats =
    kStatesStages * kStage1 + kChunk * kRaRow + kCh;

// one chunk's k and w columns (the CTA's) and v rows into a ring stage
__device__ __forceinline__ void load_kwv(float* st, const float* __restrict__ k,
                                         const float* __restrict__ w,
                                         const float* __restrict__ v,
                                         size_t at, size_t row,
                                         const Share& x) {
  if (threadIdx.x < kSliceCopies) {
    const int o = x.ts * kSRow + x.cs;
    cp_async16(st + o, k + at + x.gs);
    cp_async16(st + kChunk * kSRow + o, w + at + x.gs);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    cp_async16(st + 2 * kChunk * kSRow + (x.tw + h * kChunk / 2) * kWRow
                   + x.cw,
               v + at + x.gw + h * (kChunk / 2) * row);
}

__global__ void __launch_bounds__(kThreads, kStatesBlocks)
    rwkv_wkv_bwd_states_kernel(const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ w,
                               float* __restrict__ ckpt, int T, int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* kb_s = smem + kStatesStages * kStage1;   // (k Bs)^T's rows, [t][c]
  float* al_s = kb_s + kChunk * kRaRow;           // A_L

  const int tid = threadIdx.x;
  const int rank = blockIdx.x % kSplit;
  const int bh = blockIdx.x / kSplit;
  const int b = bh / H;
  const int h = bh - b * H;
  const int c0 = rank * kCh;
  const size_t row = static_cast<size_t>(H) * kHead;
  const size_t base = static_cast<size_t>(b) * T * row + h * kHead;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  float* ck = ckpt + static_cast<size_t>(bh) * n_chunks * kHead * kHead
              + c0 * kHead;                    // + chunk * kHead * kHead
  const Share cp = share_of(row, c0);
  const int n_carried = n_chunks - 1;

  // chunks 0 .. kStatesStages - 2 in flight; one commit group per chunk
  // (an empty one past the end), so "all but kStatesStages - 2 groups
  // done" always means this chunk's copies are
#pragma unroll
  for (int x = 0; x < kStatesStages - 1; ++x) {
    if (x < n_carried)
      load_kwv(smem + x * kStage1, k, w, v,
               base + static_cast<size_t>(x) * kChunk * row, row, cp);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  float S[8];
#pragma unroll
  for (int x = 0; x < 8; ++x) S[x] = 0.f;
  for (int ci = 0; ci < n_chunks; ++ci) {
    store_rows(S, ck + static_cast<size_t>(ci) * kHead * kHead, kHead);
    if (ci == n_carried) break;                 // the last carry is unused
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStatesStages - 2));
    __syncthreads();            // this chunk's stage has landed; the stage
                                // refilled below was read a chunk ago
    const int nx = ci + kStatesStages - 1;
    if (nx < n_carried)
      load_kwv(smem + (nx % kStatesStages) * kStage1, k, w, v,
               base + static_cast<size_t>(nx) * kChunk * row, row, cp);
    asm volatile("cp.async.commit_group;\n" ::);
    const float* st = smem + (ci % kStatesStages) * kStage1;
    if (tid < kCh) {                            // k Bs and A_L per channel
      float bs = 1.f;
#pragma unroll
      for (int t = kChunk - 1; t >= 0; --t) {
        kb_s[t * kRaRow + tid] = st[t * kSRow + tid] * bs;
        bs *= st[kChunk * kSRow + t * kSRow + tid];
      }
      al_s[tid] = bs;
    }
    __syncthreads();
    carry(S, kb_s, st + 2 * kChunk * kSRow, al_s);
    __syncthreads();            // kb_s and al_s are read
  }
}

__global__ void __cluster_dims__(kSplit, 1, 1)
    __launch_bounds__(kThreads, kMinBlocks)
    rwkv_wkv_bwd_kernel(const float* __restrict__ r,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ w,
                        const float* __restrict__ u,
                        const float* __restrict__ dout,
                        float* __restrict__ ckpt, float* __restrict__ dr,
                        float* __restrict__ dk, float* __restrict__ dv,
                        float* __restrict__ dw, float* __restrict__ du_part,
                        int T, int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* S0_s = smem + 2 * kStage;             // [kCh][kWRow]
  float* dS_s = S0_s + kCh * kWRow;            // [kCh][kWRow]
  float* X_s = dS_s + kCh * kWRow;             // [kCh][kChunk]: S_0 dout^T
  float* Y_s = X_s + kCh * kChunk;             // [kCh][kChunk]: dS_L v^T
  float* G_s = Y_s + kCh * kChunk;             // [kChunk][kGRow]: v dout^T
  float* A_s = G_s + kChunk * kGRow;           // [kChunk][kCh]
  float* kb_s = A_s + kChunk * kCh;            // [kChunk][kKbRow]: k Bs
  float* ra_s = kb_s + kChunk * kKbRow;        // [kChunk][kRaRow]: r A
  float* P_s = ra_s + kChunk * kRaRow;         // [kWarps][kChunk][kChunk]
  float* recv_s = P_s + kWarps * kChunk * kChunk;  // [2][kSplit][kChunk][kCh]
  float* out_s = recv_s + 2 * kSplit * kChunk * kCh;   // [3][kChunk][kCh]
  float* al_s = out_s + 3 * kChunk * kCh;      // A_L
  float* sds_s = al_s + kCh;                   // rowsum(S_0 dS_L)
  float* u_s = sds_s + kCh;
  uint64_t* bar_s = reinterpret_cast<uint64_t*>(u_s + kCh);  // recv_s's two

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x % kSplit;        // the cluster's rank
  const int bh = blockIdx.x / kSplit;
  const int b = bh / H;
  const int h = bh - b * H;
  const int c0 = rank * kCh;                   // the CTA's first channel
  const size_t row = static_cast<size_t>(H) * kHead;     // one time step
  const size_t base = static_cast<size_t>(b) * T * row + h * kHead;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  float* ck = ckpt + static_cast<size_t>(bh) * n_chunks * kHead * kHead
              + c0 * kHead;                    // + chunk * kHead * kHead

  if (tid < kCh) u_s[tid] = u[h * kHead + c0 + tid];
  const Share cp = share_of(row, c0);
  if (tid == 0) {
    hopper::mbar_init(hopper::smem_addr(bar_s), 1);
    hopper::mbar_init(hopper::smem_addr(bar_s + 1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive();             // every CTA's mbarriers are set up
  cluster_wait();

  // -- the chunks in reverse, carrying dS --------------------------------
  float dS[8];
#pragma unroll
  for (int x = 0; x < 8; ++x) dS[x] = 0.f;
  store_rows(dS, dS_s, kWRow);
  {
    const int t0 = (n_chunks - 1) * kChunk;
    load_stage(stage_at(smem), r, k, w, v, dout,
               base + static_cast<size_t>(t0) * row, row, T - t0, true, cp);
    load_state(S0_s, ck + static_cast<size_t>(n_chunks - 1) * kHead * kHead,
               cp);
  }
  // phase B's lanes: channel c = 4 warp + cg, slots j and j + 8
  const int cg = lane >> 3, j = lane & 7, c = 4 * warp + cg;
  float du = 0.f, du_c = 0.f;  // du and its compensation (Kahan)
  int s = 0, used = 0;          // the stage (and dv buffer), chunks done
  for (int ci = n_chunks - 1; ci >= 0; --ci, s ^= 1, ++used) {
    const int t0 = ci * kChunk;
    const int n = min(kChunk, T - t0);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    const Stage st = stage_at(smem + s * kStage);
    if (ci > 0)
      load_stage(stage_at(smem + (s ^ 1) * kStage), r, k, w, v, dout,
                 base + static_cast<size_t>(t0 - kChunk) * row, row, kChunk,
                 true, cp);

    // -- A: the Gram products on three warps, the decays on the fourth ---
    if (warp < 3) {
      float o[2][4];
      const float* a_s = warp == 0 ? S0_s : (warp == 1 ? dS_s : st.v);
      const float* b_s = warp == 1 ? st.v : st.g;
      gram(o, a_s, b_s);
      if (warp == 2)
        store_tile(o, G_s, kGRow);
      else
        store_tile(o, warp == 0 ? X_s : Y_s, kChunk);
    } else {
      // lane c < 16: channel c's w and r (prefix: A, r A, A_L); lane
      // c + 16: its w and k (suffix: k Bs); then each lane writes its
      // channel's columns back as rows, [c][t], for phase B's float4 loads
      const int c = lane & 15;
      const bool pre = lane < 16;
      float* xs = pre ? st.r : st.k;
      float wv[kChunk], xv[kChunk];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        wv[t] = st.w[t * kSRow + c];
        xv[t] = xs[t * kSRow + c];
      }
      __syncwarp();
      if (pre) {
        float a = 1.f;
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          A_s[t * kCh + c] = a;
          ra_s[t * kRaRow + c] = xv[t] * a;
          a *= wv[t];
        }
        al_s[c] = a;
      } else {
        float bs = 1.f;
#pragma unroll
        for (int t = kChunk - 1; t >= 0; --t) {
          kb_s[t * kKbRow + c] = xv[t] * bs;
          bs *= wv[t];
        }
      }
#pragma unroll
      for (int t = 0; t < kChunk; t += 4) {
        *reinterpret_cast<float4*>(xs + c * kSRow + t) =
            make_float4(xv[t], xv[t + 1], xv[t + 2], xv[t + 3]);
        if (pre)
          *reinterpret_cast<float4*>(st.w + c * kSRow + t) =
              make_float4(wv[t], wv[t + 1], wv[t + 2], wv[t + 3]);
      }
      // rowsum(S_0 dS_L): lanes c and c + 16 take 32 columns each
      const int half = lane >> 4;
      float acc = 0.f;
#pragma unroll
      for (int x = 0; x < 32; x += 4) {
        const float4 a = ld4(S0_s + c * kWRow + 32 * half + x);
        const float4 d = ld4(dS_s + c * kWRow + 32 * half + x);
        acc = __fmaf_rn(a.x, d.x, acc);
        acc = __fmaf_rn(a.y, d.y, acc);
        acc = __fmaf_rn(a.z, d.z, acc);
        acc = __fmaf_rn(a.w, d.w, acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 16);
      if (lane < 16) sds_s[c] = acc;
    }
    __syncthreads();
    if (ci > 0)
      load_state(S0_s, ck + static_cast<size_t>(ci - 1) * kHead * kHead,
                 cp);

    // -- B: eight lanes a channel, lane j its slots j and j + 8 -----------
    // (r, k and w now [c][t]: a channel's 16 steps in four float4s).  Slot
    // i's a_ti is 0 for t <= i and W_it is needed for t >= i, so slot j + 8
    // runs only the steps t >= 8.
    {
      const float* wc = st.w + c * kSRow;
      const float* rc = st.r + c * kSRow;
      const float* kc = st.k + c * kSRow;
      const float* xc = X_s + c * kChunk;
      const float* glo = G_s + j * kGRow;           // rows j, j + 8 of G
      const float* ghi = G_s + (j + 8) * kGRow;
      const float uc = u_s[c];
      // backward: Hlo[t] = W_jt (all t), Hhi[t - 8] = W_{j+8},t (t >= 8),
      // U_t = S_0 . dS_{t+1} for the channel; W_jj, W_{j+8},{j+8} and U at
      // t = j and j + 8 kept
      float Hlo[kChunk], Hhi[kChunk / 2];
      float hlo = Y_s[c * kChunk + j], hhi = Y_s[c * kChunk + j + 8];
      float uw = sds_s[c], Ulo = 0.f, Uhi = 0.f, Wlo = 0.f, Whi = 0.f;
#pragma unroll
      for (int t0 = kChunk - 4; t0 >= 0; t0 -= 4) {
        const float4 w4 = ld4(wc + t0), r4 = ld4(rc + t0), x4 = ld4(xc + t0);
        const float4 gl4 = ld4(glo + t0);
        const float4 gh4 = t0 >= kChunk / 2 ? ld4(ghi + t0) : gl4;
        const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
        const float rs[4] = {r4.x, r4.y, r4.z, r4.w};
        const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
        const float gl[4] = {gl4.x, gl4.y, gl4.z, gl4.w};
        const float gh[4] = {gh4.x, gh4.y, gh4.z, gh4.w};
#pragma unroll
        for (int e = 3; e >= 0; --e) {
          const int t = t0 + e;
          Hlo[t] = hlo;
          if (t >= kChunk / 2) {
            Hhi[t - kChunk / 2] = hhi;
            if (t - kChunk / 2 == j) {
              Whi = hhi;
              Uhi = uw;
            }
            hhi = __fmaf_rn(ws[e], hhi, rs[e] * gh[e]);
          } else if (t == j) {
            Wlo = hlo;
            Ulo = uw;
          }
          hlo = __fmaf_rn(ws[e], hlo, rs[e] * gl[e]);
          uw = __fmaf_rn(ws[e], uw, rs[e] * xs[e]);
        }
      }
      // forward: alo = a_tj, ahi = a_t,j+8; the slots' p_t = a W (dw) and
      // q_t = a G (dr) summed in the lane, at pq[e + 2 (t >= 8) + 4 (t % 8)]
      // (e 0 for p, 1 for q), and the scores' columns j and j + 8 below the
      // diagonal, r_t a
      float pq[4 * kChunk / 2], Plo[kChunk], Phi[kChunk / 2];
      float alo = 0.f, ahi = 0.f;
#pragma unroll
      for (int t0 = 0; t0 < kChunk; t0 += 4) {
        const float4 w4 = ld4(wc + t0), r4 = ld4(rc + t0), k4 = ld4(kc + t0);
        const float4 gl4 = ld4(glo + t0);
        const float4 gh4 = t0 >= kChunk / 2 ? ld4(ghi + t0) : gl4;
        const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
        const float rs[4] = {r4.x, r4.y, r4.z, r4.w};
        const float ks[4] = {k4.x, k4.y, k4.z, k4.w};
        const float gl[4] = {gl4.x, gl4.y, gl4.z, gl4.w};
        const float gh[4] = {gh4.x, gh4.y, gh4.z, gh4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + e;
          const int x = 2 * (t >= kChunk / 2) + 4 * (t % (kChunk / 2));
          Plo[t] = rs[e] * alo;
          if (t < kChunk / 2) {
            pq[x] = alo * Hlo[t];
            pq[x + 1] = alo * gl[e];
            alo = t == j ? ks[e] : ws[e] * alo;
          } else {
            pq[x] = __fmaf_rn(ahi, Hhi[t - kChunk / 2], alo * Hlo[t]);
            pq[x + 1] = __fmaf_rn(ahi, gh[e], alo * gl[e]);
            Phi[t - kChunk / 2] = rs[e] * ahi;
            alo = ws[e] * alo;
            ahi = t - kChunk / 2 == j ? ks[e] : ws[e] * ahi;
          }
        }
      }
      // the sums over the 16 slots: over the channel's 8 lanes, each round
      // a lane keeps half of its values and adds its partner's; lane j
      // ends with (p, q) at t = j and t = j + 8
#pragma unroll
      for (int m = 4, cnt = 2 * kChunk / 2; m > 0; m >>= 1, cnt >>= 1) {
        const bool upper = j & m;
#pragma unroll
        for (int x = 0; x < 2 * kChunk / 2; ++x) {
          if (x < cnt) {
            const float keep = upper ? pq[x + cnt] : pq[x];
            const float send = upper ? pq[x] : pq[x + cnt];
            pq[x] = keep + __shfl_xor_sync(0xffffffffu, send, m);
          }
        }
      }
      float dg[2];                              // the scores' diagonal
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = j + 8 * hh;
        const float at = A_s[t * kCh + c], ei = G_s[t * kGRow + t];
        const float ri = rc[t], ki = kc[t];
        out_s[t * kCh + c] = pq[2 * hh + 1] + at * xc[t] + uc * ki * ei;  // dr
        out_s[kChunk * kCh + t * kCh + c] =                                // dk
            (hh ? Whi : Wlo) + ri * uc * ei;
        out_s[2 * kChunk * kCh + t * kCh + c] =                            // dw
            pq[2 * hh] + at * (hh ? Uhi : Ulo);
        const float term = ri * ki * ei - du_c, sum = du + term;
        du_c = (sum - du) - term;
        du = sum;
        dg[hh] = ri * uc * ki;
      }
      // the scores' columns over the warp's four channels (lanes 8 apart):
      // each round a lane keeps half of its steps; then per warp to shared
#pragma unroll
      for (int m = 16, cnt = kChunk / 2; m >= 8; m >>= 1, cnt >>= 1) {
        const bool upper = lane & m;
#pragma unroll
        for (int x = 0; x < kChunk / 2; ++x) {
          if (x < cnt) {
            const float keep = upper ? Plo[x + cnt] : Plo[x];
            const float send = upper ? Plo[x] : Plo[x + cnt];
            Plo[x] = keep + __shfl_xor_sync(0xffffffffu, send, m);
          }
          if (x < cnt / 2) {
            const float keep = upper ? Phi[x + cnt / 2] : Phi[x];
            const float send = upper ? Phi[x] : Phi[x + cnt / 2];
            Phi[x] = keep + __shfl_xor_sync(0xffffffffu, send, m);
          }
        }
        dg[0] += __shfl_xor_sync(0xffffffffu, dg[0], m);
        dg[1] += __shfl_xor_sync(0xffffffffu, dg[1], m);
      }
      float* pw = P_s + warp * kChunk * kChunk;   // [t][i]
#pragma unroll
      for (int x = 0; x < 4; ++x) pw[(4 * cg + x) * kChunk + j] = Plo[x];
#pragma unroll
      for (int x = 0; x < 2; ++x)
        pw[(kChunk / 2 + 2 * cg + x) * kChunk + j + 8] = Phi[x];
      __syncwarp();
      if (cg == 0) {
        pw[j * kChunk + j] += dg[0];
        pw[(j + 8) * kChunk + j + 8] += dg[1];
      }
    }
    __syncthreads();

    // -- C: the previous chunk's dv, its kSplit partials received; the
    // arrival that frees their buffer (after the store that needs the
    // loads, so the loads are done); this chunk's partial, pushed to the
    // CTAs that own its columns; the outputs; the carry.  The cluster's
    // barriers only order buffer reuse: the partials travel by st.async,
    // seen through each buffer's mbarrier.
    const bool later = ci + 1 < n_chunks;
    if (later) {
      cluster_wait();           // every CTA has read the buffer sent to now
      hopper::mbar_wait(hopper::smem_addr(bar_s + (s ^ 1)),
                        ((used - 1) >> 1) & 1);
      if (tid < kSliceCopies && cp.ts < min(kChunk, T - t0 - kChunk)) {
        const float4 sum = partials_sum(recv_s + (s ^ 1) * kSplit * kChunk
                                        * kCh, cp);
        *reinterpret_cast<float4*>(dv + base + static_cast<size_t>(t0)
                                   * row + cp.gs + kChunk * row) = sum;
      }
    }
    cluster_arrive_relaxed();
    // the scores P_ti (t >= i; 0 above the diagonal): the warps'
    // partials summed in order into the first, each thread its own entries
#pragma unroll
    for (int x = 0; x < kChunk * kChunk / kThreads; ++x) {
      const int e = tid + x * kThreads;
      float p = 0.f;
      if (e / kChunk >= e % kChunk) {
#pragma unroll
        for (int y = 0; y < kWarps; ++y) p += P_s[y * kChunk * kChunk + e];
      }
      P_s[e] = p;
    }
    __syncthreads();
    {
      // dv's partial, columns 16 warp ..: (k Bs) dS_L over the CTA's
      // channels, then P^T dout
      const int g = lane >> 2, q = lane & 3;
      float o[2][4] = {};
      unsigned ah[4], al[4];
#pragma unroll
      for (int k0 = 0; k0 < kCh; k0 += 8) {
        a_frag<false>(kb_s, kKbRow, 0, k0, ah, al);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma3(o[nt], ah, al, dS_s, kWRow, k0, 16 * warp + 8 * nt);
      }
#pragma unroll
      for (int j0 = 0; j0 < kChunk; j0 += 8) {
        a_frag<true>(P_s, kChunk, 0, j0, ah, al);      // A (t, j) = P_jt
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma3(o[nt], ah, al, st.g, kWRow, j0, 16 * warp + 8 * nt);
      }
      // columns 16 warp .. belong to CTA rank warp: this CTA's partial
      // takes slot `rank` of its buffer s
      if (tid == 0)
        hopper::mbar_expect_tx(hopper::smem_addr(bar_s + s),
                               sizeof(float) * kSplit * kChunk * kCh);
      const uint32_t to_bar = cluster_addr(bar_s + s, warp);
      const float* slot = recv_s + (s * kSplit + rank) * kChunk * kCh;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = 8 * nt + 2 * q;
        st_async2(cluster_addr(slot + g * kCh + col, warp), o[nt][0],
                  o[nt][1], to_bar);
        st_async2(cluster_addr(slot + (g + 8) * kCh + col, warp), o[nt][2],
                  o[nt][3], to_bar);
      }
    }
    if (tid < kSliceCopies) {
      const size_t at = base + static_cast<size_t>(t0) * row + cp.gs;
      if (cp.ts < n) {
        const int o = cp.ts * kCh + cp.cs;
        *reinterpret_cast<float4*>(dr + at) = ld4(out_s + o);
        *reinterpret_cast<float4*>(dk + at) = ld4(out_s + kChunk * kCh + o);
        *reinterpret_cast<float4*>(dw + at) =
            ld4(out_s + 2 * kChunk * kCh + o);
      }
    }
    carry(dS, ra_s, st.g, al_s);
    __syncthreads();            // every read of dS_s in this chunk is done
    store_rows(dS, dS_s, kWRow);
  }
  cluster_wait();
  hopper::mbar_wait(hopper::smem_addr(bar_s + (s ^ 1)),
                    ((used - 1) >> 1) & 1);
  if (tid < kSliceCopies && cp.ts < min(kChunk, T)) {
    const float4 sum = partials_sum(recv_s + (s ^ 1) * kSplit * kChunk * kCh,
                                    cp);
    *reinterpret_cast<float4*>(dv + base + cp.gs) = sum;
  }
  // du over the chunk's steps (lane j holds steps j and j + 8 of every
  // chunk, a compensated sum over the T / 8 terms), in a fixed order
#pragma unroll
  for (int m = 4; m > 0; m >>= 1) du += __shfl_xor_sync(0xffffffffu, du, m);
  if (j == 0) du_part[static_cast<size_t>(bh) * kHead + c0 + c] = du;
  // every partial sent to this CTA has arrived: it may leave
}

// du (H, 64) = the per-(b, h) partials summed over b in order
__global__ void rwkv_wkv_bwd_du_kernel(const float* __restrict__ du_part,
                                       float* __restrict__ du, int B, int H) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= H * kHead) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    s = __fadd_rn(s, du_part[static_cast<size_t>(b) * H * kHead + x]);
  du[x] = s;
}

}  // namespace

// K, V: the head size; only 64 is built.  ckpt: B * H * ceil(T / 16) * 64
// * 64 float32 scratch; du_part: B * H * 64 float32 scratch.  Launches the
// first pass (the states at chunk starts), the second (clusters of kSplit
// CTAs a head), then the sum of du over b.  Returns cudaErrorInvalidValue
// for another head size, or for a pointer that is not 16-byte aligned.
extern "C" int repro_rwkv_wkv_bwd(const float* r, const float* k,
                                  const float* v, const float* w,
                                  const float* u, const float* dout,
                                  float* ckpt, float* du_part, float* dr,
                                  float* dk, float* dv, float* dw, float* du,
                                  int B, int T, int H, int K, int V,
                                  cudaStream_t stream) {
  if (K != kHead || V != kHead) return static_cast<int>(cudaErrorInvalidValue);
  const size_t any = reinterpret_cast<size_t>(r) | reinterpret_cast<size_t>(k)
                     | reinterpret_cast<size_t>(v) | reinterpret_cast<size_t>(w)
                     | reinterpret_cast<size_t>(dout)
                     | reinterpret_cast<size_t>(ckpt)
                     | reinterpret_cast<size_t>(dr) | reinterpret_cast<size_t>(dk)
                     | reinterpret_cast<size_t>(dv) | reinterpret_cast<size_t>(dw);
  if (any % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0) return 0;
  const int smem = static_cast<int>(sizeof(float)) * kSmemFloats;
  const int states_smem = static_cast<int>(sizeof(float)) * kStatesSmemFloats;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        rwkv_wkv_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(rwkv_wkv_bwd_states_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               states_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(rwkv_wkv_bwd_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  if (T > 0) {
    rwkv_wkv_bwd_states_kernel<<<B * H * kSplit, kThreads, states_smem,
                                 stream>>>(k, v, w, ckpt, T, H);
    rwkv_wkv_bwd_kernel<<<B * H * kSplit, kThreads, smem, stream>>>(
        r, k, v, w, u, dout, ckpt, dr, dk, dv, dw, du_part, T, H);
  } else {
    cudaMemsetAsync(du_part, 0, sizeof(float) * B * H * kHead, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv_wkv_bwd_du_kernel<<<(H * kHead + 255) / 256, 256, 0, stream>>>(
      du_part, du, B, H);
  return static_cast<int>(cudaGetLastError());
}
