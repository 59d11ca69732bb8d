// Batched integral image (summed-area table) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/integral_image/kernel.py:42
// (integral_image_pallas; _integral_kernel at :26) and the zero top row
// and left column that src/repro/kernels/integral_image/ops.py:24 pads
// on: (n, h, w) f32 -> (n, h+1, w+1) f32, out[:, i, j] = sum(img[:, :i, :j]).
//
// What bounds it on the card: bytes.  Each pixel is read once and each
// table entry written once; the two adds per pixel are nothing beside
// that (main path: 56 frames of 144x176, 11.4 MB, 3.4 us at 3.35 TB/s).
//
// Design: one block per frame, two passes in a fixed sequential order so
// that the table is bit-equal to the plain PyTorch version
// (kernels/integral_image/ref.py) on the same card.  Pass 1 gives each
// thread whole rows and prefix-sums them along w; pass 2 gives each thread
// whole columns and prefix-sums them along h, reading what pass 1 wrote
// (visible to the block after __syncthreads()).  The TPU kernel carried a
// row between sequential grid steps; here a block walks the whole frame,
// and frames run in parallel, one per SM.  Pass 1 reads and writes with a
// row stride between neighbouring threads and the table makes a second
// trip through L2; a strip-parallel scan with warp shuffles is the later
// fix, and what a 2160x3840 frame (one block) needs to be fast.

#include <cuda_runtime.h>

namespace {

__global__ void integral_image_kernel(const float* __restrict__ img,
                                      float* __restrict__ out, int h, int w) {
  const int w1 = w + 1;
  const float* src = img + static_cast<size_t>(blockIdx.x) * h * w;
  float* dst = out + static_cast<size_t>(blockIdx.x) * (h + 1) * w1;

  for (int j = threadIdx.x; j < w1; j += blockDim.x) dst[j] = 0.f;
  // pass 1: row prefix, one row per thread
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    const float* row = src + static_cast<size_t>(i) * w;
    float* orow = dst + static_cast<size_t>(i + 1) * w1;
    orow[0] = 0.f;
    float acc = row[0];
    orow[1] = acc;
    for (int j = 1; j < w; ++j) {
      acc = __fadd_rn(acc, row[j]);
      orow[j + 1] = acc;
    }
  }
  __syncthreads();
  // pass 2: column prefix, one column per thread
  for (int j = 1 + threadIdx.x; j < w1; j += blockDim.x) {
    float acc = dst[w1 + j];
    for (int i = 2; i <= h; ++i) {
      float* cell = dst + static_cast<size_t>(i) * w1 + j;
      acc = __fadd_rn(acc, *cell);
      *cell = acc;
    }
  }
}

}  // namespace

extern "C" int repro_integral_image(const float* img, float* out, int n,
                                    int h, int w, cudaStream_t stream) {
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  int longest = h > w ? h : w;
  int threads = ((longest + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  integral_image_kernel<<<n, threads, 0, stream>>>(img, out, h, w);
  return static_cast<int>(cudaGetLastError());
}
