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
// What bounds it on the card: the taps.  Every tap is one 4-byte read of
// the frame's table; from shared memory, at 32 such reads per SM per
// clock, stage 0 of the S=64 funnel (1,792 frames x 25,853 windows x 33
// stumps x 8 taps) needs ~1.5 ms, three times what its float32 operations
// need and far more than its bytes (ii, items and scores cross once).
//
// Design, two paths in one entry point, both bit-equal to the plain
// version (kernels/haar_frontend/ref.py):
// * the table path (haar_stage_table_kernel), for stages with at least
//   kTableMinCap slots a frame: a block stages its frame's whole table
//   (145 x 177 floats at the paper's scan, 102,660 B) in shared memory,
//   with the stage's tap positions, weights and stump parameters beside it
//   (123,456 B in all at 9 scales x 33 stumps: one block of kTableThreads
//   a SM), so that every tap is one shared-memory read.  The scan steps
//   windows by 2 pixels, so in row order a warp's 32 windows would read
//   each of 16 banks twice a tap; the table is staged de-interleaved (even
//   entries, then odd ones, the second half starting 16 banks on), which
//   puts those 32 reads in 32 banks.  Tap positions relative to base >> 1
//   are staged for an even and an odd window base, so a tap costs what it
//   would in row order.  The copy reads the row in 16-byte segments (a frame's row of ii
//   starts 16-byte aligned only for every fourth row; the first and last
//   segment's other floats are dropped).  A frame's slots are cut over
//   several blocks, each with its own copy of the table, when the frames
//   alone would not fill the card (S = 1: 28 frames).
// * the global path (haar_stage_kernel), for the small stages after the
//   first (128 slots a frame in the funnel), where staging 100 KB to serve
//   a few thousand taps does not pay: one thread per (frame, slot), the
//   table read through L1/L2.
// Taps and stumps are summed in slot order without FMA contraction, as
// the plain version does.  The item's float base and scale id are clamped
// in float before the int conversion (camera/viola_jones.py:586-589 in
// the JAX package) and every tap index is clamped into [0, L-1]: the table
// path checks once per window, from the scale's least and largest offset,
// whether a tap can leave the frame, and scores such a window with clamped
// taps from global memory.  Zero-weight tap slots are read like the
// others: ii * 0 is NaN where ii is, as in the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 8;             // corner taps per weak classifier
constexpr int kThreads = 256;         // global path
constexpr int kTableThreads = 1024;   // table path, one block a SM
constexpr int kTableMinCap = 2048;    // slots a frame below which: global path
constexpr int kWindows = 4;           // windows a thread scores together

struct alignas(sizeof(int) * kSlots) Taps {  // a stump's staged tap positions
  int p[kSlots];
};

// The frame's table is staged de-interleaved: entry idx of the row at
// position (idx & 1) * half + (idx >> 1), half = 16 mod 32.  The scan steps
// windows by 2 pixels, so a warp's 32 windows read 32 taps 2 floats apart:
// in row order that is two reads in each of 16 banks, de-interleaved it is
// one read in each of 32 banks (windows 1 pixel apart read the two halves,
// at most two reads a bank).
__host__ __device__ inline int table_half(int L) {
  return ((L + 1) / 2 + 15) / 32 * 32 + 16;
}

// Byte layout of the table path's dynamic shared memory: tap positions for
// even and odd window bases, weights, stump parameters (threshold,
// polarity, alpha, 0), each scale's least and largest tap offset, then the
// de-interleaved table.
struct Layout {
  int taps, weights, params, range, table, bytes;
};

__host__ __device__ inline Layout table_layout(int L, int n_scales, int sz) {
  Layout l;
  l.taps = 0;
  l.weights = l.taps + static_cast<int>(sizeof(Taps)) * 2 * n_scales * sz;
  l.params = l.weights + 2 * 16 * sz;
  l.range = l.params + 16 * sz;
  l.table = (l.range + 8 * n_scales + 15) / 16 * 16;
  l.bytes = l.table + 4 * 2 * table_half(L);
  return l;
}

__device__ __forceinline__ void item_of(const float* item, int L,
                                        int n_scales, int* base, int* sid,
                                        float* inv) {
  const float fb = fminf(fmaxf(item[0], 0.f), static_cast<float>(L - 1));
  const float fs =
      fminf(fmaxf(item[1], 0.f), static_cast<float>(n_scales - 1));
  *base = __float2int_rz(fb);
  *sid = __float2int_rz(fs);
  *inv = item[2];
}

__device__ __forceinline__ float vote_of(float resp, float inv, float thr,
                                         float pol, float alpha,
                                         float score) {
  resp = __fmul_rn(resp, inv);
  const float d = __fsub_rn(resp, thr);
  const float sgn = d > 0.f ? 1.f : (d < 0.f ? -1.f : d);  // NaN stays NaN
  float vote = __fmul_rn(pol, sgn);
  if (vote == 0.f) vote = 1.f;
  return __fadd_rn(score, __fmul_rn(vote, alpha));
}

// The stage's weights (two float4 a stump) and stump parameters
// (threshold, polarity, alpha, 0) into shared memory.
__device__ __forceinline__ void stage_stumps(const float* __restrict__ weights,
                                             const float* __restrict__ thresholds,
                                             const float* __restrict__ polarity,
                                             const float* __restrict__ alphas,
                                             int sz, float4* s_w,
                                             float4* s_par) {
  for (int q = threadIdx.x; q < sz; q += blockDim.x) {
    s_w[2 * q] = make_float4(weights[q * kSlots], weights[q * kSlots + 1],
                             weights[q * kSlots + 2], weights[q * kSlots + 3]);
    s_w[2 * q + 1] =
        make_float4(weights[q * kSlots + 4], weights[q * kSlots + 5],
                    weights[q * kSlots + 6], weights[q * kSlots + 7]);
    s_par[q] = make_float4(thresholds[q], polarity[q], alphas[q], 0.f);
  }
}

// One window's stage score, every tap index clamped into the frame's row
// in global memory: the global path's windows, and the table path's whose
// taps can leave the frame.
__device__ __noinline__ float clamped_score(const float* __restrict__ table,
                                            int L, int base,
                                            const int* __restrict__ off,
                                            const float4* w,
                                            const float4* par, int sz,
                                            float inv) {
  float score = 0.f;
  for (int k = 0; k < sz; ++k) {
    const float4 wa = w[2 * k], wb = w[2 * k + 1];
    const float wk[kSlots] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    float resp = 0.f;
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      const int idx = min(max(base + off[k * kSlots + c], 0), L - 1);
      resp = __fadd_rn(resp, __fmul_rn(table[idx], wk[c]));
    }
    const float4 p = par[k];
    score = vote_of(resp, inv, p.x, p.y, p.z, score);
  }
  return score;
}

__global__ void haar_stage_kernel(const float* __restrict__ ii, int L,
                                  const float* __restrict__ items, int cap,
                                  const int* __restrict__ offsets,
                                  int n_scales,
                                  const float* __restrict__ weights,
                                  const float* __restrict__ thresholds,
                                  const float* __restrict__ polarity,
                                  const float* __restrict__ alphas, int sz,
                                  float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float4* s_w = smem4;                          // weights, 2 a stump
  float4* s_par = s_w + 2 * sz;                 // threshold, polarity, alpha
  int* s_off = reinterpret_cast<int*>(s_par + sz);
  const int n_off = n_scales * sz * kSlots;
  for (int t = threadIdx.x; t < n_off; t += blockDim.x) s_off[t] = offsets[t];
  stage_stumps(weights, thresholds, polarity, alphas, sz, s_w, s_par);
  __syncthreads();

  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= cap) return;
  const size_t row = blockIdx.y;
  int base, sid;
  float inv;
  item_of(items + (row * cap + slot) * 3, L, n_scales, &base, &sid, &inv);
  out[row * cap + slot] = clamped_score(ii + row * L, L, base,
                                        s_off + sid * sz * kSlots, s_w,
                                        s_par, sz, inv);
}

// The stage scores of P windows that share a scale and a base parity,
// every tap inside the frame: window p's tap at position pos0[p] +
// taps[k].p[c] of the de-interleaved table.  The stump's positions,
// weights and parameters are read once for the P windows.
template <int P>
__device__ __forceinline__ void table_scores(const float* tab,
                                             const int (&pos0)[P],
                                             const Taps* taps,
                                             const float4* w,
                                             const float4* par, int sz,
                                             const float (&inv)[P],
                                             float (&score)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) score[p] = 0.f;
  for (int k = 0; k < sz; ++k) {
    const Taps tp = taps[k];
    const float4 wa = w[2 * k], wb = w[2 * k + 1];
    const float wk[kSlots] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    const float4 pr = par[k];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float* at = tab + pos0[p];
      float resp = 0.f;
#pragma unroll
      for (int c = 0; c < kSlots; ++c)
        resp = __fadd_rn(resp, __fmul_rn(at[tp.p[c]], wk[c]));
      score[p] = vote_of(resp, inv[p], pr.x, pr.y, pr.z, score[p]);
    }
  }
}

__global__ void __launch_bounds__(kTableThreads, 1)
    haar_stage_table_kernel(const float* __restrict__ ii, int L,
                            const float* __restrict__ items, int cap,
                            const int* __restrict__ offsets, int n_scales,
                            const float* __restrict__ weights,
                            const float* __restrict__ thresholds,
                            const float* __restrict__ polarity,
                            const float* __restrict__ alphas, int sz,
                            float* __restrict__ out, int per_block) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout lay = table_layout(L, n_scales, sz);
  Taps* s_taps = reinterpret_cast<Taps*>(smem + lay.taps);
  float4* s_w = reinterpret_cast<float4*>(smem + lay.weights);
  float4* s_par = reinterpret_cast<float4*>(smem + lay.params);
  int* s_lo = reinterpret_cast<int*>(smem + lay.range);
  int* s_hi = s_lo + n_scales;
  float* tab = reinterpret_cast<float*>(smem + lay.table);
  const int half = table_half(L);

  const int tid = threadIdx.x;
  const size_t row = blockIdx.y;
  const float* src = ii + row * L;
  // the row in 16-byte segments (the first and last may hold neighbours'
  // floats, which are dropped), four loads in flight a thread
  const int head = static_cast<int>((reinterpret_cast<size_t>(src) & 15) / 4);
  const float4* seg = reinterpret_cast<const float4*>(src - head);
  const int n_seg = (head + L + 3) / 4;
  for (int q0 = 0; q0 < n_seg; q0 += 4 * kTableThreads) {
    float4 x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = q0 + j * kTableThreads + tid;
      if (q < n_seg) x[j] = seg[q];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = q0 + j * kTableThreads + tid;
      if (q < n_seg) {
        const float e[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int idx = 4 * q - head + c;
          if (idx >= 0 && idx < L) tab[(idx & 1) * half + (idx >> 1)] = e[c];
        }
      }
    }
  }

  for (int q = tid; q < n_scales; q += kTableThreads) {
    s_lo[q] = L;
    s_hi[q] = -L;
  }
  stage_stumps(weights, thresholds, polarity, alphas, sz, s_w, s_par);
  __syncthreads();              // s_lo / s_hi set before the atomics
  // tap positions relative to (base >> 1), for an even and an odd base:
  // base + o = 2 (base >> 1) + (parity + o)
  int* s_pos = reinterpret_cast<int*>(s_taps);
  const int n_off = n_scales * sz * kSlots;
  for (int q = tid; q < n_off; q += kTableThreads) {
    const int o = min(max(offsets[q], -L), L);
    s_pos[q] = (o & 1) * half + (o >> 1);
    s_pos[n_off + q] = ((o + 1) & 1) * half + ((o + 1) >> 1);
    atomicMin(s_lo + q / (sz * kSlots), o);
    atomicMax(s_hi + q / (sz * kSlots), o);
  }
  __syncthreads();

  // a warp takes kWindows x 32 slots at a time, lane l the slots l + 32 p:
  // neighbouring lanes score neighbouring windows, and a lane's windows
  // (128 slots apart at most) nearly always share a scale and a parity,
  // so that one read of a stump's tables serves all of them
  const int first = blockIdx.x * per_block;
  const int last = min(cap, first + per_block);
  const int lane = tid & 31;
  for (int s0 = first + (tid >> 5) * 32 * kWindows; s0 < last;
       s0 += kTableThreads * kWindows) {
    int base[kWindows], sid[kWindows], pos0[kWindows];
    float inv[kWindows], score[kWindows];
    bool inside[kWindows];
#pragma unroll
    for (int p = 0; p < kWindows; ++p) {
      const int slot = min(s0 + lane + 32 * p, last - 1);
      item_of(items + (row * cap + slot) * 3, L, n_scales, &base[p], &sid[p],
              &inv[p]);
      inside[p] = base[p] + s_lo[sid[p]] >= 0 && base[p] + s_hi[sid[p]] <= L - 1;
      pos0[p] = base[p] >> 1;
    }
    bool together = true;
#pragma unroll
    for (int p = 0; p < kWindows; ++p)
      together = together && inside[p] && sid[p] == sid[0] &&
                 (base[p] & 1) == (base[0] & 1);
    if (together) {
      table_scores<kWindows>(tab, pos0,
                          s_taps + ((base[0] & 1) * n_scales + sid[0]) * sz,
                          s_w, s_par, sz, inv, score);
    } else {
#pragma unroll
      for (int p = 0; p < kWindows; ++p) {
        if (inside[p]) {
          const int one_pos[1] = {pos0[p]};
          const float one_inv[1] = {inv[p]};
          float one[1];
          table_scores<1>(tab, one_pos,
                          s_taps + ((base[p] & 1) * n_scales + sid[p]) * sz,
                          s_w, s_par, sz, one_inv, one);
          score[p] = one[0];
        } else {
          score[p] = clamped_score(src, L, base[p],
                                   offsets + sid[p] * sz * kSlots, s_w, s_par,
                                   sz, inv[p]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kWindows; ++p) {
      const int slot = s0 + lane + 32 * p;
      if (slot < last) out[row * cap + slot] = score[p];
    }
  }
}

}  // namespace

extern "C" int repro_haar_stage(const float* ii, int L, const float* items,
                                int rows, int cap, const int* offsets,
                                int n_scales, const float* weights,
                                const float* thresholds,
                                const float* polarity, const float* alphas,
                                int sz, float* out, cudaStream_t stream) {
  if (rows <= 0 || cap <= 0) return 0;
  static int sms = 0, max_smem = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(haar_stage_table_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 max_smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(haar_stage_table_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) {
      sms = 0;
      return static_cast<int>(err);
    }
  }
  const int table_smem = table_layout(L, n_scales, sz).bytes;
  if (cap >= kTableMinCap && table_smem <= max_smem) {
    // blocks a frame: enough to fill every SM, never fewer than
    // kTableThreads slots a block
    int split = sms / rows;
    split = max(1, min(split, (cap + kTableThreads - 1) / kTableThreads));
    const int per_block = (cap + split - 1) / split;
    dim3 grid((cap + per_block - 1) / per_block, rows);
    haar_stage_table_kernel<<<grid, kTableThreads, table_smem, stream>>>(
        ii, L, items, cap, offsets, n_scales, weights, thresholds, polarity,
        alphas, sz, out, per_block);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float4) * 3 * static_cast<size_t>(sz)
                      + sizeof(int) * static_cast<size_t>(n_scales) * sz * kSlots;
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
