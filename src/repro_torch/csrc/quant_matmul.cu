// int8 x int8 -> int32 GEMM with the face-auth NN's epilogue, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul/kernel.py:55
// (quant_matmul_pallas; _qmm_kernel at :24): (m, k) int8 x (k, n) int8,
// accumulated exactly in int32, then in the reference's order
// (kernel.py:44-51):
//   y = f32(acc) * scale            (scale = f32(scale_x * scale_w))
//   y = y + bias[j]                 (when a bias is given)
//   t = (y - lo) / (hi - lo) * (entries - 1), clipped to [0, entries-1],
//   y = lut[trunc(t)]               (when the LUT is applied)
//
// What bounds it on the card: bytes at the main path's shapes.  Layer 1
// is 5,376 x 400 x 8 (2.2 MB in, 0.17 MB out, 34 M int8 ops) and layer 2
// 5,376 x 8 x 1: far below the ~1,000 int8 ops per byte where H100's
// tensor cores would be the limit.
//
// Design: one thread per output element with a plain int32 MAC loop over
// k; neighbouring threads share an x row (one broadcast read) and read
// neighbouring w columns.  Every epilogue step is a separate IEEE
// operation (__fmul_rn, __fadd_rn, __fdiv_rn; the library is also built
// with -fmad=false) and the index is truncated with __float2int_rz, so the
// output is bit-equal to the plain version and to the JAX package's.  A
// fused two-layer kernel and s8 tensor-core (wgmma) tiles for the large
// GEMM case are the later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void quant_matmul_kernel(const int8_t* __restrict__ x,
                                    const int8_t* __restrict__ w,
                                    const float* __restrict__ bias,
                                    const float* __restrict__ lut,
                                    int entries, int m, int k, int n,
                                    float scale, int apply_lut, float lo,
                                    float range, float* __restrict__ out) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(m) * n) return;
  const int i = static_cast<int>(e / n);
  const int j = static_cast<int>(e % n);
  const int8_t* xr = x + static_cast<size_t>(i) * k;
  int acc = 0;
  for (int kk = 0; kk < k; ++kk)
    acc += static_cast<int>(xr[kk]) * static_cast<int>(w[static_cast<size_t>(kk) * n + j]);
  float y = __fmul_rn(__int2float_rn(acc), scale);
  if (bias != nullptr) y = __fadd_rn(y, bias[j]);
  if (apply_lut) {
    const float top = static_cast<float>(entries - 1);
    float t = __fmul_rn(__fdiv_rn(__fsub_rn(y, lo), range), top);
    t = fminf(fmaxf(t, 0.f), top);
    y = lut[__float2int_rz(t)];
  }
  out[e] = y;
}

}  // namespace

extern "C" int repro_quant_matmul(const int8_t* x, const int8_t* w,
                                  const float* bias, const float* lut,
                                  int entries, int m, int k, int n,
                                  float scale, int apply_lut, float lo,
                                  float range, float* out,
                                  cudaStream_t stream) {
  if (m <= 0 || n <= 0) return 0;
  const size_t total = static_cast<size_t>(m) * n;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  quant_matmul_kernel<<<blocks, kThreads, 0, stream>>>(
      x, w, bias, lut, entries, m, k, n, scale, apply_lut, lo, range, out);
  return static_cast<int>(cudaGetLastError());
}
