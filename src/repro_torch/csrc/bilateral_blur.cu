// n_steps steps of the bilateral-grid [1,2,1]^3 blur for Hopper, value and
// weight grids of every camera pair in one launch.
//
// Replaces the TPU kernel src/repro/kernels/bilateral_blur/kernel.py:53
// (bilateral_blur_pallas; _blur_kernel at :37), which makes one step; the
// refinement (kernels/bilateral_blur/ops.py) runs n_iters of them back to
// back, and this kernel runs up to kMaxSteps of them in one launch.  With
// n_steps = 1 it is the TPU kernel's function.  Semantics are those of
// kernels/bilateral_blur/ref.py (blur_121) iterated, bit for bit: over
// (P, gy, gx, gr) f32, each step a pass along gy, then gx, then gr, each
//   out = (0.25*lo + 0.5*g) + 0.25*hi        rounded to float32,
// with lo/hi the neighbours along the axis and the edge vertex of that
// step standing in for the missing one at the grid's borders.
//
// What bounds it on the card: bytes.  Read once and written once, both
// grids of the rig's 8 pairs (2 x 8 x 136x241x17 f32, 71.3 MB) take 21.3 us
// at 3.35 TB/s, where one launch per step moved them 8 times a frame.  This
// design adds shared-memory loads the function does not need (about 3 a
// value and step, times the halo's recomputation), which at 32 a clock per
// SM take longer than the bytes.
//
// Design: temporal blocking.  A block owns an interior tile of ty x tx
// vertices of one grid, with all gr bins, and stages the tile plus a halo
// of n_steps vertices in gy and gx in shared memory (cp.async), then runs
// every step there; the region it can compute shrinks by one vertex a step
// on each side that has a halo, and after n_steps it is the interior,
// which alone goes back to device memory.  A tile that touches a border of
// the grid stages nothing outside it and does not shrink on that side:
// edge replication is per step (the step's own border vertex stands in for
// the missing neighbour), so clamped copies staged once would be wrong
// from the second step on.  Each pass walks its lines in place with a
// window of three values in registers (unrolled by 8): one shared load
// and one store per value and pass.  The gy pass takes lines (x, r), adjacent threads on
// adjacent words; the gx pass lines (y, r), the row stride padded to gr
// modulo 32 words so that a warp's lines hit 32 banks; the gr pass one
// vertex a thread (a stride of 17 words is conflict-free).  The caller
// chooses the tiles (kernels/bilateral_blur/cuda.py::tile_shape: equal
// tiles of at most 34 x 32, which at the rig's grid, 136 x 241, gives 4 x 8
// tiles of 34 x 31 and 512 blocks, 4 waves of one 160 KB block a SM) and
// this entry checks that they fit.  gr is a
// template parameter (17 at every shape of the path) with a generic
// instantiation.  Products by 0.25 and 0.5 are exact; the sums use the
// explicit IEEE intrinsics and the library is built with -fmad=false, so
// every output is the same float operations in the same order as
// iterating the plain version.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 1024;
constexpr int kBlocksPerSm = 1;
constexpr int kMaxSteps = 8;     // the halo, and the steps of one launch
constexpr int kSmemLimit = 232448;

// Blurs the n values p[0], p[stride], ... in place.  lo_edge / hi_edge:
// the line starts / ends at the grid's border, where its end value stands
// in for the missing neighbour; otherwise p[-stride] / p[n * stride] hold
// the neighbours (values of the same step).  N > 0 fixes n.  Each value's
// quarter, 0.25 * v, is the hi term of the value before it and the lo
// term of the one after: it is computed once and carried, and an output
// is (q_lo + 0.5 * g) + q_hi, the plain version's operations in its order.
template <int N>
__device__ __forceinline__ void blur_line(float* p, int n, int stride,
                                          bool lo_edge, bool hi_edge) {
  if constexpr (N > 0) n = N;
  float cur = p[0];
  float q_prev = __fmul_rn(0.25f, lo_edge ? cur : p[-stride]);
  float q_cur = __fmul_rn(0.25f, cur);
  auto step = [&](int i, float next) {
    const float q_next = __fmul_rn(0.25f, next);
    p[i * stride] = __fadd_rn(__fadd_rn(q_prev, __fmul_rn(0.5f, cur)),
                              q_next);
    q_prev = q_cur;
    q_cur = q_next;
    cur = next;
  };
  if constexpr (N > 0) {
#pragma unroll
    for (int i = 0; i < N - 1; ++i) step(i, p[(i + 1) * stride]);
  } else {
#pragma unroll 8
    for (int i = 0; i < n - 1; ++i) step(i, p[(i + 1) * stride]);
  }
  step(n - 1, hi_edge ? cur : p[n * stride]);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

template <int GR>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    bilateral_blur_kernel(const float* __restrict__ val,
                          const float* __restrict__ wt,
                          float* __restrict__ val_out,
                          float* __restrict__ wt_out, int gy, int gx,
                          int gr_runtime, int ty, int tx, int n_tiles_x,
                          int steps, int rs) {
  extern __shared__ float v[];
  const int gr = GR > 0 ? GR : gr_runtime;
  const int pair = blockIdx.y >> 1;
  const size_t offset = static_cast<size_t>(pair) * gy * gx * gr;
  const float* src = ((blockIdx.y & 1) ? wt : val) + offset;
  float* dst = ((blockIdx.y & 1) ? wt_out : val_out) + offset;
  const int tile_y = blockIdx.x / n_tiles_x;
  const int y0 = tile_y * ty, x0 = (blockIdx.x - tile_y * n_tiles_x) * tx;
  const int y1 = min(gy, y0 + ty), x1 = min(gx, x0 + tx);
  // staged region, clipped to the grid: no vertex outside it is staged
  const int sy0 = max(0, y0 - steps), sy1 = min(gy, y1 + steps);
  const int sx0 = max(0, x0 - steps), sx1 = min(gx, x1 + steps);
  const int SY = sy1 - sy0, SX = sx1 - sx0;
  const bool top = sy0 == 0, bottom = sy1 == gy;
  const bool left = sx0 == 0, right = sx1 == gx;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarps = kThreads / 32;

  for (int y = warp; y < SY; y += kWarps) {         // one row a warp
    const float* s = src + (static_cast<size_t>(sy0 + y) * gx + sx0) * gr;
    float* d = v + y * rs;
    for (int i = lane; i < SX * gr; i += 32) cp_async4(d + i, s + i);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int s = 1; s <= steps; ++s) {
    // the region of step s, local: [ya, yb) x [xa, xb); the gy pass also
    // covers the columns of step s - 1 that the gx pass reads
    const int ya = top ? 0 : s, yb = bottom ? SY : SY - s;
    const int xa = left ? 0 : s, xb = right ? SX : SX - s;
    const int pxa = left ? 0 : s - 1, pxb = right ? SX : SX - s + 1;
    const int ny = yb - ya, nx = xb - xa;
    for (int l = threadIdx.x; l < (pxb - pxa) * gr; l += kThreads)
      blur_line<0>(v + ya * rs + pxa * gr + l, ny, rs, top, bottom);
    __syncthreads();
    for (int l = threadIdx.x; l < ny * gr; l += kThreads) {
      const int y = l / gr, r = l - y * gr;
      blur_line<0>(v + (ya + y) * rs + xa * gr + r, nx, gr, left, right);
    }
    __syncthreads();
    // one vertex a thread; (y, x) advanced without a division
    const int dy = kThreads / nx, dx = kThreads - dy * nx;
    int y = threadIdx.x / nx, x = threadIdx.x - y * nx;
    while (y < ny) {
      blur_line<GR>(v + (ya + y) * rs + (xa + x) * gr, gr, 1, true, true);
      x += dx;
      y += dy;
      if (x >= nx) {
        x -= nx;
        ++y;
      }
    }
    __syncthreads();
  }

  const int iy = y0 - sy0, ix = x0 - sx0;           // the interior, local
  for (int y = warp; y < y1 - y0; y += kWarps) {
    const float* s = v + (iy + y) * rs + ix * gr;
    float* d = dst + (static_cast<size_t>(y0 + y) * gx + x0) * gr;
    for (int i = lane; i < (x1 - x0) * gr; i += 32) d[i] = s[i];
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// val, wt, val_out, wt_out: (P, gy, gx, gr) f32 on the card; the outputs
// are n_steps blur steps of the inputs (1 <= n_steps <= kMaxSteps), on
// interior tiles of ty x tx vertices staged in rows of rs floats (at least
// the staged row's sx * gr), smem bytes of shared memory a block (at least
// the staged region's, at most kSmemLimit).
extern "C" int repro_bilateral_blur(const float* val, const float* wt,
                                    float* val_out, float* wt_out, int P,
                                    int gy, int gx, int gr, int n_steps,
                                    int ty, int tx, int rs, int smem,
                                    cudaStream_t stream) {
  if (P <= 0 || gy <= 0 || gx <= 0 || gr <= 0) return 0;
  if (n_steps < 1 || n_steps > kMaxSteps || ty < 1 || tx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sy = std::min(gy, ty + 2 * n_steps);
  const int sx = std::min(gx, tx + 2 * n_steps);
  if (rs < sx * gr || smem > kSmemLimit ||
      static_cast<size_t>(smem) < sizeof(float) * static_cast<size_t>(sy) * rs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles_x = ceil_div(gx, tx);
  dim3 grid(ceil_div(gy, ty) * n_tiles_x, 2 * P);
  auto kernel = gr == 17 ? bilateral_blur_kernel<17>
                         : bilateral_blur_kernel<0>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, stream>>>(val, wt, val_out, wt_out, gy, gx,
                                           gr, ty, tx, n_tiles_x, n_steps,
                                           rs);
  return static_cast<int>(cudaGetLastError());
}
