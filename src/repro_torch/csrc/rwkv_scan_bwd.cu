// The backward of the RWKV6 WKV recurrence from the zero state, for Hopper.
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
// in float32.  Nothing divides by w: w = 0 in a channel (where the model's
// exp(-exp(x)) underflows) is exact here as in the forward.
//
// Layout: the model's, r, k, v, w, dout and dr, dk, dv, dw (B, T, H, 64),
// u and du (H, 64), all float32, contiguous and 16-byte aligned.
//
// What bounds it on the card: the arithmetic.  At the rwkv6-7b training
// step (B 8, T 2048, H 64) the reverse recurrence does 14 float32
// operations per state entry and step, 6.0e10 in all (0.90 ms on the CUDA
// cores at 67 TFLOP/s); the five inputs and four outputs are 2.4 GB (0.72
// ms at 3.35 TB/s).  This design adds its own scratch, the states at chunk
// starts below, 1.07 GB written and read (0.64 ms more of traffic).
//
// Design: one block of 256 threads per (b, h); thread (c, q) owns state
// row (channel) c = tid / 4 and columns 16 q .. 16 q + 15 of S and of dS,
// so each state update is elementwise in the thread and every sum over
// columns is a sum of 16 in order then across the 4 threads of a quad.
// The backward needs S_t at every step, and S_t cannot be got back from
// S_{t+1} without dividing by w.  So a forward sweep first writes S at
// every chunk start (kChunk = 16 steps) to a scratch buffer (T / 16 x 16
// KB per (b, h), 1.07 GB at the step above); the backward sweep then walks
// the chunks in reverse, rebuilding each chunk's states from its start in
// two halves of kSub = 8 steps held in registers (the later half first),
// and walks each half's steps backward.  dv_t sums over the 64 channels:
// a warp sums its 8 channels by shuffles, and the 8 warps' partials go
// through shared memory, summed in warp order once per chunk.  du comes
// as per-(b, h) partials that a second kernel sums over b in order.  No
// atomics: every gradient is the same bits on every run.

#include <cuda_runtime.h>

namespace {

constexpr int kHead = 64;            // K = V
constexpr int kChunk = 16;           // steps between stored states
constexpr int kSub = 8;              // steps rebuilt into registers at once
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = kHead * kHead / kThreads;   // 16 state columns a thread
constexpr int kTile = kChunk * kHead;             // floats of one chunk's rows
// shared: r, k, v, w, dout; dr, dk, dw; dv partials per warp; bonus sums
constexpr int kSmemFloats = 8 * kTile + kWarps * kTile + kWarps * kChunk;

static_assert(kThreads == 4 * kHead && kCols == 16,
              "four threads a channel, 16 columns each");
static_assert(kChunk % kSub == 0, "whole halves");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& a, int e) {
  return e == 0 ? a.x : (e == 1 ? a.y : (e == 2 ? a.z : a.w));
}

// n rows (steps) of one head of a (T, H, 64) tensor into [kChunk][64];
// rows past n are `pad`
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t row, int n, float pad) {
  for (int i = threadIdx.x; i < kTile / 4; i += kThreads) {
    const int t = i / (kHead / 4), c = 4 * (i % (kHead / 4));
    *reinterpret_cast<float4*>(dst + t * kHead + c) =
        t < n ? ld4(src + t * row + c) : make_float4(pad, pad, pad, pad);
  }
}

// the thread's 16 columns one step on: S = w S + k v
__device__ __forceinline__ void step_state(float (&S)[kCols], float wt,
                                           float kt, const float* vt) {
#pragma unroll
  for (int i = 0; i < kCols; i += 4) {
    const float4 vv = ld4(vt + i);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      S[i + e] = __fadd_rn(__fmul_rn(wt, S[i + e]), __fmul_rn(kt, comp(vv, e)));
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__global__ void __launch_bounds__(kThreads, 1)
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
  float* rs = reinterpret_cast<float*>(smem4);
  float* ks = rs + kTile;
  float* vs = ks + kTile;
  float* ws = vs + kTile;
  float* dos = ws + kTile;
  float* drs = dos + kTile;
  float* dks = drs + kTile;
  float* dws = dks + kTile;
  float* dvp = dws + kTile;                     // [kWarps][kChunk][64]
  float* gp = dvp + kWarps * kTile;             // [kWarps][kChunk]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ch = tid >> 2, q = tid & 3, c0 = kCols * q;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t row = static_cast<size_t>(H) * kHead;
  const size_t base = static_cast<size_t>(b) * T * row + h * kHead;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  float* ck = ckpt + static_cast<size_t>(bh) * n_chunks * kHead * kHead
              + ch * kHead + c0;
  const float uc = u[h * kHead + ch];

  // -- forward sweep: S at every chunk start ---------------------------
  float S[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) S[i] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk;
    const int n = min(kChunk, T - t0);
    if (c > 0) {
      float* dst = ck + static_cast<size_t>(c) * kHead * kHead;
#pragma unroll
      for (int i = 0; i < kCols; i += 4)
        *reinterpret_cast<float4*>(dst + i) =
            make_float4(S[i], S[i + 1], S[i + 2], S[i + 3]);
    }
    __syncthreads();
    load_tile(ks, k + base + t0 * row, row, n, 0.f);
    load_tile(vs, v + base + t0 * row, row, n, 0.f);
    load_tile(ws, w + base + t0 * row, row, n, 1.f);
    __syncthreads();
    for (int t = 0; t < n; ++t)
      step_state(S, ws[t * kHead + ch], ks[t * kHead + ch],
                 vs + t * kHead + c0);
  }

  // -- backward sweep ---------------------------------------------------
  float dS[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) dS[i] = 0.f;
  float du = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int n = min(kChunk, T - t0);
    __syncthreads();            // the last chunk's tiles are read
    // padded steps (r = k = v = dout = 0, w = 1) change nothing
    load_tile(rs, r + base + t0 * row, row, n, 0.f);
    load_tile(ks, k + base + t0 * row, row, n, 0.f);
    load_tile(vs, v + base + t0 * row, row, n, 0.f);
    load_tile(ws, w + base + t0 * row, row, n, 1.f);
    load_tile(dos, dout + base + t0 * row, row, n, 0.f);
    __syncthreads();
    const float* src = ck + static_cast<size_t>(c) * kHead * kHead;
    for (int half = kChunk / kSub - 1; half >= 0; --half) {
#pragma unroll
      for (int i = 0; i < kCols; i += 4) {
        const float4 x = c > 0 ? ld4(src + i)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        S[i] = x.x;
        S[i + 1] = x.y;
        S[i + 2] = x.z;
        S[i + 3] = x.w;
      }
      for (int t = 0; t < half * kSub; ++t)
        step_state(S, ws[t * kHead + ch], ks[t * kHead + ch],
                   vs + t * kHead + c0);
      float St[kSub][kCols];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int t = half * kSub + j;
#pragma unroll
        for (int i = 0; i < kCols; ++i) St[j][i] = S[i];
        if (j + 1 < kSub)
          step_state(S, ws[t * kHead + ch], ks[t * kHead + ch],
                     vs + t * kHead + c0);
      }
#pragma unroll
      for (int j = kSub - 1; j >= 0; --j) {
        const int t = half * kSub + j;
        const float rt = rs[t * kHead + ch];
        const float kt = ks[t * kHead + ch];
        const float wt = ws[t * kHead + ch];
        const float* vt = vs + t * kHead + c0;
        const float* gt = dos + t * kHead + c0;
        // sums over the columns: a = S_t dout, bb = dS_{t+1} . S_t,
        // cc = dS_{t+1} v_t, e = v_t . dout_t
        float a = 0.f, bb = 0.f, cc = 0.f, e = 0.f;
#pragma unroll
        for (int i = 0; i < kCols; i += 4) {
          const float4 vv = ld4(vt + i), gg = ld4(gt + i);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float old = dS[i + x];
            a = __fmaf_rn(St[j][i + x], comp(gg, x), a);
            bb = __fmaf_rn(old, St[j][i + x], bb);
            cc = __fmaf_rn(old, comp(vv, x), cc);
            e = __fmaf_rn(comp(vv, x), comp(gg, x), e);
            // dv partial of this column over the warp's 8 channels (lanes
            // 4 apart, in the butterfly's order); lanes 0-3 keep it
            float pv = __fmul_rn(old, kt);
            pv = __fadd_rn(pv, __shfl_xor_sync(0xffffffffu, pv, 4));
            pv = __fadd_rn(pv, __shfl_xor_sync(0xffffffffu, pv, 8));
            pv = __fadd_rn(pv, __shfl_xor_sync(0xffffffffu, pv, 16));
            if (lane < 4) dvp[(warp * kChunk + t) * kHead + c0 + i + x] = pv;
            // dS_t = w_t dS_{t+1} + r_t dout_t
            dS[i + x] = __fadd_rn(__fmul_rn(wt, old),
                                  __fmul_rn(rt, comp(gg, x)));
          }
        }
        a = quad_sum(a);
        bb = quad_sum(bb);
        cc = quad_sum(cc);
        e = quad_sum(e);
        if (q == 0) {
          drs[t * kHead + ch] = __fadd_rn(a, __fmul_rn(__fmul_rn(uc, kt), e));
          dks[t * kHead + ch] = __fadd_rn(cc, __fmul_rn(__fmul_rn(rt, uc), e));
          dws[t * kHead + ch] = bb;
          du = __fadd_rn(du, __fmul_rn(__fmul_rn(rt, kt), e));
        }
        // the bonus's scalar sum_k r u k over this warp's channels
        float g = q == 0 ? __fmul_rn(__fmul_rn(rt, uc), kt) : 0.f;
#pragma unroll
        for (int m = 1; m < 32; m <<= 1)
          g = __fadd_rn(g, __shfl_xor_sync(0xffffffffu, g, m));
        if (lane == 0) gp[warp * kChunk + t] = g;
      }
    }
    __syncthreads();
    // the chunk's outputs: dv summed over the warps in order, dr, dk, dw
    for (int i = tid; i < kTile; i += kThreads) {
      const int t = i / kHead, col = i % kHead;
      if (t >= n) continue;
      float sv = 0.f, sg = 0.f;
#pragma unroll
      for (int x = 0; x < kWarps; ++x) {
        sv = __fadd_rn(sv, dvp[(x * kChunk + t) * kHead + col]);
        sg = __fadd_rn(sg, gp[x * kChunk + t]);
      }
      const size_t at = base + static_cast<size_t>(t0 + t) * row + col;
      dv[at] = __fadd_rn(sv, __fmul_rn(sg, dos[t * kHead + col]));
      dr[at] = drs[t * kHead + col];
      dk[at] = dks[t * kHead + col];
      dw[at] = dws[t * kHead + col];
    }
  }
  if (q == 0) du_part[static_cast<size_t>(bh) * kHead + ch] = du;
}

// du (H, 64) = the per-(b, h) partials summed over b in order
__global__ void rwkv_wkv_bwd_du_kernel(const float* __restrict__ du_part,
                                       float* __restrict__ du, int B, int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * kHead) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    s = __fadd_rn(s, du_part[static_cast<size_t>(b) * H * kHead + i]);
  du[i] = s;
}

}  // namespace

// K, V: the head size; only 64 is built.  ckpt: B * H * ceil(T / 16) * 64
// * 64 float32 scratch; du_part: B * H * 64 float32 scratch.  Launches the
// recurrence's backward, then the sum of du over b.  Returns
// cudaErrorInvalidValue for another head size, or for a pointer that is
// not 16-byte aligned.
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
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv_wkv_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  if (T > 0)
    rwkv_wkv_bwd_kernel<<<B * H, kThreads, smem, stream>>>(
        r, k, v, w, u, dout, ckpt, dr, dk, dv, dw, du_part, T, H);
  else
    cudaMemsetAsync(du_part, 0, sizeof(float) * B * H * kHead, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv_wkv_bwd_du_kernel<<<(H * kHead + 255) / 256, 256, 0, stream>>>(
      du_part, du, B, H);
  return static_cast<int>(cudaGetLastError());
}
