// RWKV6 WKV recurrence from the zero state, for Hopper.
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
// u (H, K); out (B, T, H, V) and the state (B, H, K, V), all contiguous.
// K = V = 64 (RWKV6's head size).
//
// What bounds it on the card: bytes.  At the rwkv6-7b prefill (B 8,
// T 4096, H 64) the inputs and output are 2.7 GB (0.80 ms at 3.35 TB/s);
// the chunked form's 4.3e10 operations would take 0.64 ms at the float32
// rate.
//
// Design: the simplest right one, a sequential recurrence.  One block per
// (b, h) and one thread per value column j, which keeps its column S[:, j]
// (64 floats) in registers for all T steps: nothing of the state touches
// memory until the end.  Every 32 steps the block stages r, k, w and v of
// those steps in shared memory with coalesced loads (one 256-byte row per
// step and tensor), so the inner loop reads shared memory only.  This keeps
// the per-step arithmetic of the reference (no log-space decays, so no
// clamp of w and no overflow at strong decays, and a ragged last chunk is
// just a shorter loop).  Its limit is latency: 4,096 dependent steps per
// block and only B*H = 512 blocks of 2 warps in flight.  The chunked form
// with tensor-core products (kernel.py:55-67's pairwise decays) is later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int kHead = 64;       // K = V
constexpr int kChunk = 32;      // steps staged at a time

__global__ void __launch_bounds__(kHead)
    rwkv_wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, float* __restrict__ out,
                    float* __restrict__ state, int T, int H) {
  __shared__ float rs[kChunk][kHead];
  __shared__ float ks[kChunk][kHead];
  __shared__ float ws[kChunk][kHead];
  __shared__ float vs[kChunk][kHead];
  __shared__ float us[kHead];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j = threadIdx.x;
  const size_t row = static_cast<size_t>(H) * kHead;      // one time step
  const size_t base = static_cast<size_t>(b) * T * row + h * kHead;

  us[j] = u[h * kHead + j];
  float S[kHead];
#pragma unroll
  for (int i = 0; i < kHead; ++i) S[i] = 0.f;

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int n = min(kChunk, T - t0);
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const size_t at = base + (t0 + tt) * row + j;
      rs[tt][j] = r[at];
      ks[tt][j] = k[at];
      ws[tt][j] = w[at];
      vs[tt][j] = v[at];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][j];
      float o = 0.f;
#pragma unroll
      for (int i = 0; i < kHead; ++i) {
        const float kv = __fmul_rn(ks[tt][i], vj);
        o = __fadd_rn(o, __fmul_rn(rs[tt][i],
                                   __fadd_rn(S[i], __fmul_rn(us[i], kv))));
        S[i] = __fadd_rn(__fmul_rn(ws[tt][i], S[i]), kv);
      }
      out[base + (t0 + tt) * row + j] = o;
    }
  }
  float* sb = state + static_cast<size_t>(bh) * kHead * kHead + j;
#pragma unroll
  for (int i = 0; i < kHead; ++i) sb[i * kHead] = S[i];
}

}  // namespace

// K, V: the head size; only 64 is built.  Returns cudaErrorInvalidValue
// for another.
extern "C" int repro_rwkv_wkv(const float* r, const float* k, const float* v,
                              const float* w, const float* u, float* out,
                              float* state, int B, int T, int H, int K, int V,
                              cudaStream_t stream) {
  if (K != kHead || V != kHead) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0) return 0;
  rwkv_wkv_kernel<<<B * H, kHead, 0, stream>>>(r, k, v, w, u, out, state,
                                               T, H);
  return static_cast<int>(cudaGetLastError());
}
