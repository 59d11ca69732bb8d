// One AdaBoost cascade stage over compacted scanning windows, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/haar_frontend/kernel.py:49
// (haar_stage_scores_pallas; _stage_kernel at :31), batched over frames:
// for every (frame, slot) item (base, scale id, inv_norm) and every weak
// classifier k of the stage,
//   resp  = (sum_c ii[base + offsets[sid, k, c]] * weights[k, c]) * inv_norm
//   vote  = polarity[k] * sign(resp - thresholds[k]), 0 -> +1
//   score = sum_k alphas[k] * vote
// ii is (rows, L), items (rows, cap, 3) f32, offsets (n_scales, sz, 8) i32.
//
// What bounds it on the card: bytes in principle (ii, items and scores
// each cross once; stage 0 of the main path moves 12.6 MB), latency in
// practice: every tap is a dependent random read.  The 28 tables of the
// main path (102,660 B each, 2.9 MB) stay in the 50 MB L2.
//
// Design: one thread per (frame, slot), reading its frame's table from
// global memory through L2.  The stage's corner offsets, tap weights and
// stump parameters (about 11 KB at 9 scales x 33 stumps) are staged in
// shared memory once per block, where the TPU kernel kept them in VMEM.
// Taps and stumps are summed in slot order without FMA contraction, as
// the plain version (kernels/haar_frontend/ref.py) does, so the two agree
// exactly.  The item's float base and scale id are clamped in float
// before the int conversion (camera/viola_jones.py:586-589 in the JAX
// package) and every tap index is clamped into [0, L-1]: a no-op for a
// real window, and no device fault for a dead slot.  Staging the ii table
// itself in shared memory (100 KB fits) is the later speed-up.

#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 8;     // corner taps per weak classifier
constexpr int kThreads = 256;

__global__ void haar_stage_kernel(const float* __restrict__ ii, int L,
                                  const float* __restrict__ items, int cap,
                                  const int* __restrict__ offsets,
                                  int n_scales,
                                  const float* __restrict__ weights,
                                  const float* __restrict__ thresholds,
                                  const float* __restrict__ polarity,
                                  const float* __restrict__ alphas, int sz,
                                  float* __restrict__ out) {
  extern __shared__ float smem[];
  const int n_off = n_scales * sz * kSlots;
  int* s_off = reinterpret_cast<int*>(smem);
  float* s_w = smem + n_off;
  float* s_thr = s_w + sz * kSlots;
  float* s_pol = s_thr + sz;
  float* s_alpha = s_pol + sz;
  for (int t = threadIdx.x; t < n_off; t += blockDim.x) s_off[t] = offsets[t];
  for (int t = threadIdx.x; t < sz * kSlots; t += blockDim.x)
    s_w[t] = weights[t];
  for (int t = threadIdx.x; t < sz; t += blockDim.x) {
    s_thr[t] = thresholds[t];
    s_pol[t] = polarity[t];
    s_alpha[t] = alphas[t];
  }
  __syncthreads();

  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= cap) return;
  const size_t row = blockIdx.y;
  const float* item = items + (row * cap + slot) * 3;
  const float fb = fminf(fmaxf(item[0], 0.f), static_cast<float>(L - 1));
  const float fs = fminf(fmaxf(item[1], 0.f), static_cast<float>(n_scales - 1));
  const int base = __float2int_rz(fb);
  const int sid = __float2int_rz(fs);
  const float inv = item[2];
  const float* table = ii + row * L;
  const int* off = s_off + sid * sz * kSlots;

  float score = 0.f;
  for (int k = 0; k < sz; ++k) {
    float resp = 0.f;
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      int idx = base + off[k * kSlots + c];
      idx = min(max(idx, 0), L - 1);
      resp = __fadd_rn(resp, __fmul_rn(table[idx], s_w[k * kSlots + c]));
    }
    resp = __fmul_rn(resp, inv);
    const float d = __fsub_rn(resp, s_thr[k]);
    const float sgn = d > 0.f ? 1.f : (d < 0.f ? -1.f : d);  // NaN stays NaN
    float vote = __fmul_rn(s_pol[k], sgn);
    if (vote == 0.f) vote = 1.f;
    score = __fadd_rn(score, __fmul_rn(vote, s_alpha[k]));
  }
  out[row * cap + slot] = score;
}

}  // namespace

extern "C" int repro_haar_stage(const float* ii, int L, const float* items,
                                int rows, int cap, const int* offsets,
                                int n_scales, const float* weights,
                                const float* thresholds,
                                const float* polarity, const float* alphas,
                                int sz, float* out, cudaStream_t stream) {
  if (rows <= 0 || cap <= 0) return 0;
  const size_t smem = sizeof(float) * (static_cast<size_t>(n_scales) * sz * kSlots
                                       + static_cast<size_t>(sz) * kSlots
                                       + 3 * static_cast<size_t>(sz));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        haar_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((cap + kThreads - 1) / kThreads, rows);
  haar_stage_kernel<<<grid, kThreads, smem, stream>>>(
      ii, L, items, cap, offsets, n_scales, weights, thresholds, polarity,
      alphas, sz, out);
  return static_cast<int>(cudaGetLastError());
}
