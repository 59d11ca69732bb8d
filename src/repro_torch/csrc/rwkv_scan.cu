// RWKV6 WKV recurrence from the zero state, for Hopper: the chunked form.
//
// Replaces the TPU kernel src/repro/kernels/rwkv_scan/kernel.py:85
// (rwkv_wkv_pallas; _wkv_kernel at :33).  Semantics are those of
// kernels/rwkv_scan/ref.py (wkv_ref) and of the model's _wkv_step
// (src/repro/models/ssm.py:90-95): per head, with S_0 = 0,
//   out_t = r_t . (S_t + diag(u) k_t v_t^T)
//   S_{t+1} = diag(w_t) S_t + k_t v_t^T
// in float32.  Unlike the TPU kernel, which keeps S in scratch and drops
// it, this one also writes the final state S_T: the port's prefill hands it
// to decode as the recurrent cache.
//
// Layout: the model's, r, k, w (B, T, H, K) and v (B, T, H, V) float32,
// u (H, K); out (B, T, H, V) and the state (B, H, K, V), all contiguous
// and 16-byte aligned.  K = V = 64 (RWKV6's head size).
//
// What bounds it on the card: bytes.  At the rwkv6-7b prefill (B 8,
// T 4096, H 64) the inputs and output are 2.7 GB (0.80 ms at 3.35 TB/s);
// the chunked form's operations (2 K V per step for the state's two
// products, L K per step for the chunk's own scores) take 0.6 ms at the
// float32 rate.
//
// Design: T is cut into chunks of L steps (kChunk), walked in order by one
// block per (b, h), which keeps the head's K x V state in registers.  Per
// chunk, with local steps t, i in [0, L):
//   A_t  = prod_{j<t} w_j          (exclusive prefix product)
//   Bs_i = prod_{j>i} w_j          (exclusive suffix product)
//   D_ti = prod_{i<j<t} w_j        (pairwise, built as D *= w_t)
//   P_ti = sum_k r_t k_i D_ti  (i < t),  P_tt = sum_k r_t u k_t
//   out_t = (r_t * A_t) . S + sum_{i<=t} P_ti v_i
//   S'    = diag(A_L) S + sum_i (k_i * Bs_i) v_i^T
// Every decay is a product of w's in the linear domain: no logarithm and
// no exponential, so w = 0 (the model's exp(-exp(x)) underflows to it) is
// an exact zero, tiny products underflow to zero, and nothing overflows
// (the TPU kernel's log-space differences need a clamp of w at 1e-12; its
// factored form gives NaN at |log w| ~ 6).  The pairwise D costs one
// multiply per (t, i, k) on the FMA pipe, where exp(ecum_t - cum_i) would
// cost one SFU exponential each.  The scores are float32 FMAs, a group of
// kKQ lanes to a pair of rows that together walk L steps, summed across
// the lanes by a halving butterfly.  The two
// matrix products (the output, L x (K + L) by (K + L) x V, and the state
// carry, K x L by L x V) run on the tensor cores as 3xTF32 mma.sync
// m16n8k8 (each float32 operand split into a TF32 high part and the
// remainder, the remainder-by-remainder product dropped: about float32's
// accuracy).  The next chunk's r, k, w and v arrive by 16-byte cp.async
// into a second buffer while the block computes on the current one;
// shared rows are padded so that the fragment loads hit 32 banks.  A
// ragged last chunk is padded in shared memory with r = k = v = 0 and
// w = 1, as the JAX ops.py pads.

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

using tf32::a_frag;
using tf32::cp_async16;
using tf32::mma3;

constexpr int kHead = 64;           // K = V
constexpr int kChunk = 16;          // L: time steps per chunk
constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;       // blocks per SM the registers allow
// padded shared rows (floats): r and w 4 mod 32, k, v and S 8 mod 32
constexpr int kRRow = kHead + 4;
constexpr int kKRow = kHead + 8;
constexpr int kVRow = kHead + 8;
constexpr int kSRow = kHead + 8;
constexpr int kPRow = kChunk + 4;
// scores: kKQ lanes share a pair of rows, kCH channels each
constexpr int kKQ = kThreads / (kChunk / 2);
constexpr int kCH = kHead / kKQ;
// a thread's state: 8 C fragments of 4 (state_tensor_core)
constexpr int kStateRegs = kHead * kHead / kThreads;
constexpr int kStage = kChunk * (2 * kRRow + kKRow + kVRow);   // floats
constexpr int kSmemFloats = 2 * kStage + kHead * kSRow + kChunk * kPRow
                            + 2 * kHead;

static_assert(kThreads % (kChunk / 2) == 0 && kKQ <= 32 &&
                  (kKQ & (kKQ - 1)) == 0,
              "score lanes must be a power of two within a warp");
static_assert(kCH % 4 == 0 && kChunk % 4 == 0, "float4 tiles");
static_assert(kChunk == 16 && kHead == 64 && kThreads == 128,
              "the mma tiles: 16 steps, 64 columns, 4 warps; two threads "
              "a channel for the decays");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& a, int e) {
  return e == 0 ? a.x : (e == 1 ? a.y : (e == 2 ? a.z : a.w));
}

// -- loads ------------------------------------------------------------------

// Issue the copies of one chunk into a stage; rows past the end are filled
// with r = k = v = 0, w = 1 (no contribution, no decay).
__device__ __forceinline__ void load_chunk(
    float* st, const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ w, const float* __restrict__ v, size_t head0,
    size_t row, int n) {
  float* rs = st;
  float* ws = rs + kChunk * kRRow;
  float* ks = ws + kChunk * kRRow;
  float* vs = ks + kChunk * kKRow;
  for (int q = threadIdx.x; q < kChunk * (kHead / 4); q += kThreads) {
    const int t = q / (kHead / 4), c = 4 * (q % (kHead / 4));
    float* dr = rs + t * kRRow + c;
    float* dw = ws + t * kRRow + c;
    float* dk = ks + t * kKRow + c;
    if (t < n) {
      const size_t g = head0 + t * row + c;
      cp_async16(dr, r + g);
      cp_async16(dk, k + g);
      cp_async16(dw, w + g);
    } else {
      *reinterpret_cast<float4*>(dr) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dk) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dw) = make_float4(1.f, 1.f, 1.f, 1.f);
    }
  }
  for (int q = threadIdx.x; q < kChunk * (kHead / 4); q += kThreads) {
    const int t = q / (kHead / 4), c = 4 * (q % (kHead / 4));
    if (t < n)
      cp_async16(vs + t * kVRow + c, v + head0 + t * row + c);
    else
      *reinterpret_cast<float4*>(vs + t * kVRow + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// -- the two products on the tensor cores ---------------------------------------

// Warp wi computes the output columns 16 wi .. 16 wi + 15 (two n tiles).
__device__ __forceinline__ void out_tensor_core(const float* rs,
                                                const float* P_s,
                                                const float* S_s,
                                                const float* vs, float* out,
                                                size_t row, int n) {
  const int wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  float o[2][4] = {};
  unsigned ah[4], al[4];
#pragma unroll 2
  for (int k0 = 0; k0 < kHead; k0 += 8) {
    a_frag<false>(rs, kRRow, 0, k0, ah, al);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      mma3(o[nt], ah, al, S_s, kSRow, k0, 16 * wi + 8 * nt);
  }
#pragma unroll
  for (int i0 = 0; i0 < kChunk; i0 += 8) {
    a_frag<false>(P_s, kPRow, 0, i0, ah, al);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      mma3(o[nt], ah, al, vs, kVRow, i0, 16 * wi + 8 * nt);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = 16 * wi + 8 * nt + 2 * q;
    if (g < n)
      *reinterpret_cast<float2*>(out + g * row + col) =
          make_float2(o[nt][0], o[nt][1]);
    if (g + 8 < n)
      *reinterpret_cast<float2*>(out + (g + 8) * row + col) =
          make_float2(o[nt][2], o[nt][3]);
  }
}

// Warp wi holds the state's channels 16 wi .. 16 wi + 15 as eight C
// fragments: S[4 nt + e], n tile nt, (row, column) (g, 8 nt + 2 q),
// (g, 8 nt + 2 q + 1), (g + 8, 8 nt + 2 q), (g + 8, 8 nt + 2 q + 1).
__device__ __forceinline__ void state_tensor_core(float (&S)[kStateRegs],
                                                  const float* ks,
                                                  const float* vs,
                                                  const float* al_s) {
  const int wi = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const float a0 = al_s[16 * wi + g], a8 = al_s[16 * wi + g + 8];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    S[4 * nt + 0] *= a0;
    S[4 * nt + 1] *= a0;
    S[4 * nt + 2] *= a8;
    S[4 * nt + 3] *= a8;
  }
  unsigned ah[4], al[4];
#pragma unroll
  for (int i0 = 0; i0 < kChunk; i0 += 8) {
    a_frag<true>(ks, kKRow, 16 * wi, i0, ah, al);   // (k * Bs)^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float (&c)[4] = *reinterpret_cast<float(*)[4]>(S + 4 * nt);
      mma3(c, ah, al, vs, kVRow, i0, 8 * nt);
    }
  }
}

// (channel, column) of the thread's state register x
__device__ __forceinline__ void state_at(int x, int& ch, int& col) {
  const int wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, nt = x / 4, e = x % 4;
  ch = 16 * wi + g + (e >= 2 ? 8 : 0);
  col = 8 * nt + 2 * q + (e & 1);
}

// -- the chunk's scores ----------------------------------------------------------

// P (lower triangle and diagonal) from the raw r, k, w.  Rows pair up, i
// with L - 2 - i (and L/2 - 1 with L - 1), so that every pair walks L or
// L/2 steps t: row i's P[t][i], t > i, needs L - 1 - i of them.  A group
// of kKQ lanes takes a pair, kCH channels a lane; a lane walks its first
// row's t, then its second's, building the pairwise decay as kd *= w_t,
// and the group's L partial sums (acc[x]) are summed across its lanes by a
// halving butterfly.
__device__ __forceinline__ void chunk_scores(const float* rs, const float* ws,
                                             const float* ks,
                                             const float* u_s, float* P_s) {
  const int grp = threadIdx.x / kKQ, kq = threadIdx.x % kKQ, c0 = kq * kCH;
  const int rows[2] = {grp, grp == kChunk / 2 - 1 ? kChunk - 1
                                                  : kChunk - 2 - grp};
  const int na = kChunk - 1 - rows[0];      // steps of the first row
  const int nb = kChunk - 1 - rows[1];      // of the second
  float diag[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int c = 0; c < kCH; c += 4) {
      const float4 kk = ld4(ks + rows[h] * kKRow + c0 + c);
      const float4 rr = ld4(rs + rows[h] * kRRow + c0 + c);
      const float4 uu = ld4(u_s + c0 + c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        diag[h] = __fmaf_rn(comp(rr, e), __fmul_rn(comp(uu, e), comp(kk, e)),
                            diag[h]);
    }
  }
  float kd[kCH];
  float acc[kChunk];
#pragma unroll
  for (int x = 0; x < kChunk; ++x) {
    acc[x] = 0.f;
    if (x == 0 || x == na) {                // start of a row: D = 1
      const float* k_i = ks + rows[x == 0 ? 0 : 1] * kKRow + c0;
#pragma unroll
      for (int c = 0; c < kCH; c += 4) {
        const float4 kk = ld4(k_i + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) kd[c + e] = comp(kk, e);
      }
    }
    if (x < na + nb) {
      // t = rows[0] + 1 + x on the first row, x on the second
      const int t = x < na ? rows[0] + 1 + x : x;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCH; c += 4) {
        const float4 rr = ld4(rs + t * kRRow + c0 + c);
        const float4 ww = ld4(ws + t * kRRow + c0 + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sum = __fmaf_rn(comp(rr, e), kd[c + e], sum);
          kd[c + e] = __fmul_rn(kd[c + e], comp(ww, e));
        }
      }
      acc[x] = sum;
    }
  }
  // each round a lane keeps half of its sums and adds its partner's; once
  // one is left, the rounds add it whole.  A lane then holds the sums
  // x = (kq / kDup) kPer + j, j < kPer, as kDup lanes do.
  constexpr int kPer = kChunk >= kKQ ? kChunk / kKQ : 1;
  constexpr int kDup = kKQ >= kChunk ? kKQ / kChunk : 1;
  int cnt = kChunk;
#pragma unroll
  for (int m = kKQ / 2; m > 0; m >>= 1) {
    diag[0] += __shfl_xor_sync(0xffffffffu, diag[0], m);
    diag[1] += __shfl_xor_sync(0xffffffffu, diag[1], m);
    if (cnt > 1) {
      cnt /= 2;
      const bool upper = kq & m;
#pragma unroll
      for (int j = 0; j < kChunk / 2; ++j) {
        if (j < cnt) {
          const float keep = upper ? acc[j + cnt] : acc[j];
          const float send = upper ? acc[j] : acc[j + cnt];
          acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, m);
        }
      }
    } else {
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], m);
    }
  }
  if (kq % kDup) return;
  if (kq == 0) {
    P_s[rows[0] * kPRow + rows[0]] = diag[0];
    P_s[rows[1] * kPRow + rows[1]] = diag[1];
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int x = (kq / kDup) * kPer + j;
    if (x < na + nb) {
      const int i = x < na ? rows[0] : rows[1];
      const int t = x < na ? rows[0] + 1 + x : x;
      P_s[t * kPRow + i] = acc[j];
    }
  }
}

// -- the chunk's decays -------------------------------------------------------

// Per channel ch: A_t = prod_{j<t} w_j scales r in place and A_L goes to
// al_s; Bs_t = prod_{j>t} w_j scales k in place.  Two threads a channel:
// the first kHead take A, the next kHead Bs.
__device__ __forceinline__ void apply_decays(float* rs, const float* ws,
                                             float* ks, float* al_s) {
  const int tid = threadIdx.x, ch = tid % kHead;
  const bool pre = tid < kHead;
  float dec[kChunk];
  if (pre) {
    float a = 1.f;
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      dec[t] = a;
      a = __fmul_rn(a, ws[t * kRRow + ch]);
    }
    al_s[ch] = a;
  } else {
    float b = 1.f;
#pragma unroll
    for (int t = kChunk - 1; t >= 0; --t) {
      dec[t] = b;
      b = __fmul_rn(b, ws[t * kRRow + ch]);
    }
  }
  __syncthreads();              // every read of the raw r and k is done
  float* dst = pre ? rs + ch : ks + ch;
  const int stride = pre ? kRRow : kKRow;
#pragma unroll
  for (int t = 0; t < kChunk; ++t) dst[t * stride] *= dec[t];
  __syncthreads();
}

// -- the kernel ---------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    rwkv_wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, float* __restrict__ out,
                    float* __restrict__ state, int T, int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* S_s = smem + 2 * kStage;               // [kHead][kSRow]
  float* P_s = S_s + kHead * kSRow;             // [kChunk][kPRow]
  float* al_s = P_s + kChunk * kPRow;           // A_L per channel
  float* u_s = al_s + kHead;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t row = static_cast<size_t>(H) * kHead;     // one time step
  const size_t base = static_cast<size_t>(b) * T * row + h * kHead;
  const int n_chunks = (T + kChunk - 1) / kChunk;

  for (int q = tid; q < kHead * kSRow; q += kThreads) S_s[q] = 0.f;
  for (int q = tid; q < kChunk * kPRow; q += kThreads) P_s[q] = 0.f;
  if (tid < kHead) u_s[tid] = u[h * kHead + tid];
  if (n_chunks > 0)
    load_chunk(smem, r, k, w, v, base, row, min(kChunk, T));

  float S[kStateRegs];
#pragma unroll
  for (int x = 0; x < kStateRegs; ++x) S[x] = 0.f;

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * kChunk;
    const int n = min(kChunk, T - t0);
    float* rs = smem + (ci & 1) * kStage;
    const float* ws = rs + kChunk * kRRow;
    float* ks = rs + 2 * kChunk * kRRow;
    const float* vs = ks + kChunk * kKRow;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (ci + 1 < n_chunks)
      load_chunk(smem + ((ci + 1) & 1) * kStage, r, k, w, v,
                 base + static_cast<size_t>(t0 + kChunk) * row, row,
                 min(kChunk, T - t0 - kChunk));

    // -- scores P (lower triangle and diagonal) from the raw r, k, w -----
    chunk_scores(rs, ws, ks, u_s, P_s);

    // -- decays: prefix A (r side) and suffix Bs (k side) per channel -----
    apply_decays(rs, ws, ks, al_s);

    // -- out = (r * A) S + P v; S = diag(A_L) S + (k * Bs)^T v -------------
    out_tensor_core(rs, P_s, S_s, vs,
                    out + base + static_cast<size_t>(t0) * row, row, n);
    state_tensor_core(S, ks, vs, al_s);
    __syncthreads();            // every read of this chunk's S_s is done
#pragma unroll
    for (int x = 0; x < kStateRegs; x += 2) {
      int c, col;
      state_at(x, c, col);
      *reinterpret_cast<float2*>(S_s + c * kSRow + col) =
          make_float2(S[x], S[x + 1]);
    }
  }

  float* sb = state + static_cast<size_t>(bh) * kHead * kHead;
#pragma unroll
  for (int x = 0; x < kStateRegs; x += 2) {
    int c, col;
    state_at(x, c, col);
    *reinterpret_cast<float2*>(sb + c * kHead + col) =
        make_float2(S[x], S[x + 1]);
  }
}

}  // namespace

// K, V: the head size; only 64 is built.  Returns cudaErrorInvalidValue
// for another, or for a pointer that is not 16-byte aligned.
extern "C" int repro_rwkv_wkv(const float* r, const float* k, const float* v,
                              const float* w, const float* u, float* out,
                              float* state, int B, int T, int H, int K, int V,
                              cudaStream_t stream) {
  if (K != kHead || V != kHead) return static_cast<int>(cudaErrorInvalidValue);
  const size_t any = reinterpret_cast<size_t>(r) | reinterpret_cast<size_t>(k)
                     | reinterpret_cast<size_t>(v) | reinterpret_cast<size_t>(w)
                     | reinterpret_cast<size_t>(out)
                     | reinterpret_cast<size_t>(state);
  if (any % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0) return 0;
  const int smem = static_cast<int>(sizeof(float)) * kSmemFloats;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        rwkv_wkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(rwkv_wkv_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  rwkv_wkv_kernel<<<B * H, kThreads, smem, stream>>>(
      r, k, v, w, u, out, state, T, H);
  return static_cast<int>(cudaGetLastError());
}
