// Batched integral image (summed-area table) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/integral_image/kernel.py:42
// (integral_image_pallas; _integral_kernel at :26) and the zero top row
// and left column that src/repro/kernels/integral_image/ops.py:24 pads
// on: (n, h, w) f32 -> (n, h+1, w+1) f32, out[:, i, j] = sum(img[:, :i, :j]).
//
// What bounds it on the card: bytes.  Each pixel is read once and each
// table entry written once; the two adds per pixel are nothing beside
// that (VR cost volume: 64 tables of 2164x3844, 4.26 GB, 1.27 ms at
// 3.35 TB/s; funnel: 56 frames of 144x176, 11.4 MB, 3.4 us).
//
// The numbers: every entry is out[i][j] = fl(out[i-1][j] + R[i][j]), R[i]
// row i's sequential float32 prefix, exactly as the plain PyTorch version
// (kernels/integral_image/ref.py) sums.  Any schedule that keeps both
// recurrences sequential gives the same bits, so the table is bit-equal
// to the plain version on the same card.  Both carries start at -0.0f,
// for which fl(-0 + x) = x for every x, signed zeros included: the first
// row and column are copied as the plain version copies them.
//
// Design: one pass over the data, a decoupled chained scan over
// horizontal strips.  A block takes a strip of RS rows of one table; it
// draws the strip from a ticket counter, so strips start in order and a
// strip's predecessor has always started (it is resident or done): no
// block waits on one that cannot run.  The block walks the width in tiles
// of TW columns.  For each tile it loads the RS x TW pixels coalesced into
// shared memory (the next tile's loads are in flight in registers
// meanwhile), one thread per row extends that row's running prefix across
// the tile, then it waits until the strip above has published this tile,
// reads that strip's last table row (one row per strip, 1/RS extra
// traffic) and one thread per column carries it down the RS rows,
// writing the table rows coalesced.  Then it publishes the tile:
// `progress[strip]` counts the tiles a strip has written.  The wrapper
// allocates the ticket and the progress counters, a memset zeroes them
// before the launch; the kernel allocates nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int RS = 64;          // rows per strip (STRIP_ROWS in cuda.py)
constexpr int TW = 128;         // columns per tile = threads per block
constexpr int PITCH = TW + 1;   // shared-memory row pitch: no bank conflicts

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// 3 blocks per SM (153 registers, no spills; 33 KB of shared memory each):
// the fastest of the strip heights and occupancies that
// benchmarks/torch_kernel_variants.py compares (PERF.md)
__global__ void __launch_bounds__(TW, 3)
    integral_image_kernel(const float* __restrict__ img,
                          float* __restrict__ out, int h, int w,
                          int n_strips, int* __restrict__ ticket,
                          int* __restrict__ progress) {
  __shared__ float tile[RS * PITCH];
  __shared__ int s_ticket;
  const int tid = threadIdx.x;
  if (tid == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  const int t = s_ticket;                 // strips in order, table-major
  const int table = t / n_strips;
  const int strip = t - table * n_strips;
  const int i0 = strip * RS;
  const int rows = min(RS, h - i0);
  const size_t w1 = static_cast<size_t>(w) + 1;
  const float* src = img + (static_cast<size_t>(table) * h + i0) * w;
  float* dst = out + static_cast<size_t>(table) * (h + 1) * w1;
  const int n_tiles = (w + TW - 1) / TW;

  if (strip == 0)
    for (int j = tid; j < static_cast<int>(w1); j += TW) dst[j] = 0.f;
  if (tid < rows) dst[(i0 + 1 + tid) * w1] = 0.f;

  float next[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r)
    next[r] = (r < rows && tid < w) ? src[static_cast<size_t>(r) * w + tid]
                                    : 0.f;
  float row_acc = -0.f;                   // thread r < RS: row r's prefix

  for (int c = 0; c < n_tiles; ++c) {
    const int j = c * TW + tid;
#pragma unroll
    for (int r = 0; r < RS; ++r) tile[r * PITCH + tid] = next[r];
    __syncthreads();
    if (c + 1 < n_tiles) {
      const int jn = j + TW;
#pragma unroll
      for (int r = 0; r < RS; ++r)
        next[r] = (r < rows && jn < w) ? src[static_cast<size_t>(r) * w + jn]
                                       : 0.f;
    }
    if (tid < RS) {
      float acc = row_acc;
      float* row = tile + tid * PITCH;
#pragma unroll 16
      for (int k = 0; k < TW; ++k) {
        acc = __fadd_rn(acc, row[k]);
        row[k] = acc;
      }
      row_acc = acc;
    }
    if (strip > 0 && tid == 0) {
      // a wait that outlasts any real one (2^24 polls, seconds) traps
      // instead of hanging the card
      for (uint32_t n = 0; load_acquire(progress + t - 1) <= c; ++n)
        if (n == (1u << 24)) __trap();
      __threadfence();
    }
    __syncthreads();
    if (j < w) {
      float carry = strip > 0 ? __ldcg(dst + i0 * w1 + 1 + j) : -0.f;
      for (int r = 0; r < rows; ++r) {
        carry = __fadd_rn(carry, tile[r * PITCH + tid]);
        dst[(i0 + 1 + r) * w1 + 1 + j] = carry;
      }
    }
    __syncthreads();                      // tile read; every write issued
    if (tid == 0) {
      __threadfence();
      store_release(progress + t, c + 1);
    }
  }
}

}  // namespace

// scratch: n * ceil(h / RS) + 1 ints (the ticket, then one progress counter
// per strip), zeroed here before the launch.  Returns
// cudaErrorInvalidValue if it is smaller.
extern "C" int repro_integral_image(const float* img, float* out, int n,
                                    int h, int w, int* scratch,
                                    long long n_scratch,
                                    cudaStream_t stream) {
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  const int n_strips = (h + RS - 1) / RS;
  const long long blocks = static_cast<long long>(n) * n_strips;
  if (n_scratch < blocks + 1 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(int) * static_cast<size_t>(blocks + 1), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  integral_image_kernel<<<static_cast<unsigned>(blocks), TW, 0, stream>>>(
      img, out, h, w, n_strips, scratch, scratch + 1);
  return static_cast<int>(cudaGetLastError());
}
