// One step of the bilateral-grid [1,2,1]^3 blur for Hopper, value and
// weight grids of every camera pair in one launch.
//
// Replaces the TPU kernel src/repro/kernels/bilateral_blur/kernel.py:53
// (bilateral_blur_pallas; _blur_kernel at :37).  Semantics are those of
// kernels/bilateral_blur/ref.py (blur_121), bit for bit: over
// (P, gy, gx, gr) f32, a pass along gy, then gx, then gr, each
//   out = (0.25*lo + 0.5*g) + 0.25*hi        rounded to float32,
// with lo/hi the neighbours along the axis and the edge vertex standing in
// for the missing one at the grid's borders (edge replication).
//
// What bounds it on the card: bytes.  Each grid value is read once and
// written once (8 pairs at 2160x3840, sigma 16: 2 x 8 x 136x241x17 f32 in
// and out, 71.3 MB, 21.3 us at 3.35 TB/s); about 15 float operations per
// value are nothing beside that.
//
// Design: the TPU kernel gathered overlapping gy-blocks with a one-row halo
// into a stacked copy for its BlockSpecs.  Here a CUDA block owns a tile of
// kTileY x kTileX vertices of one grid, with all gr bins, and stages the
// tile plus a one-vertex halo in gy and gx in shared memory; halo indices
// are clamped to the grid, which is the edge replication.  The gy pass runs
// over the tile's rows and the halo columns (the gx pass needs the gy
// result there), the gx pass over the tile, the gr pass within each vertex,
// each into shared memory and the last to device memory.  Products by 0.25
// and 0.5 are exact; the sums use the explicit IEEE intrinsics and the
// library is built with -fmad=false.  Fusing the n_iters steps into one
// launch, a persistent grid and keeping the grids in L2 are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTileY = 8;
constexpr int kTileX = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ float blend(float lo, float g, float hi) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.25f, lo), __fmul_rn(0.5f, g)),
                   __fmul_rn(0.25f, hi));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void bilateral_blur_kernel(const float* __restrict__ val,
                                      const float* __restrict__ wt,
                                      float* __restrict__ val_out,
                                      float* __restrict__ wt_out, int gy,
                                      int gx, int gr) {
  extern __shared__ float smem[];
  const int row = (kTileX + 2) * gr;             // one staged row
  float* in = smem;                              // (kTileY + 2) rows
  float* a = smem + (kTileY + 2) * row;          // gy pass, kTileY rows

  const int pair = blockIdx.z >> 1;
  const size_t offset = static_cast<size_t>(pair) * gy * gx * gr;
  const float* src = ((blockIdx.z & 1) ? wt : val) + offset;
  float* dst = ((blockIdx.z & 1) ? wt_out : val_out) + offset;
  const int y0 = blockIdx.y * kTileY;
  const int x0 = blockIdx.x * kTileX;

  // stage rows y0-1 .. y0+kTileY and columns x0-1 .. x0+kTileX, clamped
  for (int i = threadIdx.x; i < (kTileY + 2) * row; i += blockDim.x) {
    const int ty = i / row;
    const int rem = i - ty * row;
    const int tx = rem / gr;
    const int r = rem - tx * gr;
    const int y = clampi(y0 - 1 + ty, 0, gy - 1);
    const int x = clampi(x0 - 1 + tx, 0, gx - 1);
    in[i] = src[(static_cast<size_t>(y) * gx + x) * gr + r];
  }
  __syncthreads();
  // gy pass over the tile's rows, halo columns included
  for (int i = threadIdx.x; i < kTileY * row; i += blockDim.x) {
    a[i] = blend(in[i], in[i + row], in[i + 2 * row]);
  }
  __syncthreads();
  // gx pass over the tile, into the staging buffer (kTileY x kTileX x gr)
  const int tile = kTileX * gr;
  for (int i = threadIdx.x; i < kTileY * tile; i += blockDim.x) {
    const int ty = i / tile;
    const int rem = i - ty * tile;             // tx * gr + r
    const float* ar = a + ty * row + rem;      // column tx - 1 of the halo
    in[i] = blend(ar[0], ar[gr], ar[2 * gr]);
  }
  __syncthreads();
  // gr pass within each vertex, to device memory
  for (int i = threadIdx.x; i < kTileY * tile; i += blockDim.x) {
    const int ty = i / tile;
    const int rem = i - ty * tile;
    const int tx = rem / gr;
    const int r = rem - tx * gr;
    const int y = y0 + ty;
    const int x = x0 + tx;
    if (y >= gy || x >= gx) continue;
    const float* v = in + i - r;               // bin 0 of this vertex
    const float out = blend(v[r > 0 ? r - 1 : 0], v[r],
                            v[r < gr - 1 ? r + 1 : gr - 1]);
    dst[(static_cast<size_t>(y) * gx + x) * gr + r] = out;
  }
}

}  // namespace

extern "C" int repro_bilateral_blur(const float* val, const float* wt,
                                    float* val_out, float* wt_out, int P,
                                    int gy, int gx, int gr,
                                    cudaStream_t stream) {
  if (P <= 0 || gy <= 0 || gx <= 0 || gr <= 0) return 0;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(2 * kTileY + 2) * (kTileX + 2) * gr;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bilateral_blur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((gx + kTileX - 1) / kTileX, (gy + kTileY - 1) / kTileY, 2 * P);
  bilateral_blur_kernel<<<grid, kThreads, smem, stream>>>(
      val, wt, val_out, wt_out, gy, gx, gr);
  return static_cast<int>(cudaGetLastError());
}
