// int8 x int8 -> int32 GEMM with the face-auth NN's epilogue, and the whole
// 400-8-1 NN in one launch, on Hopper's int8 tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul/kernel.py:55
// (quant_matmul_pallas; _qmm_kernel at :24): (m, k) int8 x (k, n) int8,
// accumulated exactly in int32, then in the reference's order
// (kernel.py:44-51):
//   y = f32(acc) * scale            (scale = f32(scale_x * scale_w))
//   y = y + bias[j]                 (when a bias is given)
//   t = (y - lo) / (hi - lo) * (entries - 1), clipped to [0, entries-1],
//   y = lut[trunc(t)]               (when the LUT is applied)
// Every epilogue step is a separate IEEE operation (__fmul_rn, __fadd_rn,
// __fdiv_rn; the library is built with -fmad=false) and the index is
// truncated with __float2int_rz, so outputs are bit-equal to the plain
// version and to the JAX package's.  The int32 sums are exact in any
// order, so the tensor cores' order changes nothing.
//
// What bounds it on the card: bytes.  The main path's NN reads 5,376 rows
// of 400 float32 pixels at S = 1 (8.6 MB, 2.6 us at 3.35 TB/s) for 34 M
// int8 multiply-adds; a 1024^3 GEMM is 2.1 G multiply-adds (1.1 us of
// int8 tensor cores) against 6.3 MB (1.9 us).
//
// Both entry points share one tile routine: int8 tensor-core products,
// mma.sync m16n8k32 (s8 x s8 -> s32) with A (x) row-major and B (w)
// k-major in shared memory, each fragment register one aligned 32-bit
// shared-memory read; rows are padded by 16 bytes so that the 8 rows of a
// fragment fall on distinct banks.  k is zero-padded to a multiple of 32
// in shared memory: zero terms add nothing to an exact int32 sum.
//
// repro_quant_matmul (the general GEMM): x and w tiles come into a 2-stage
// ring by 16-byte cp.async (zero-filled past m and k), the next tile's
// copy in flight under this tile's products; w arrives row-major
// (k, n) and is transposed to k-major in shared memory by byte permutes.
// Shapes whose rows are not 16-byte multiples (k or n not a multiple of
// 16) are staged by plain loads instead.  Two tile shapes: 64 x 128 for
// n > 8 (8 warps of 32 x 32), 64 x 8 for n <= 8 (4 warps of 16 x 8).
//
// repro_quant_nn (nn_forward_quantized): per tile of 16 rows, the float32
// rows are read once, coalesced (the tile is one contiguous range),
// quantized in registers as quantize_static does (x * f32(1/f32(scale_x)),
// round half to even, clamp to +-qmax), and stored as int8; w1, k-major
// and zero-padded once on the host, is copied into shared memory under
// those loads.  Layer 1 is split over the 4 warps by k-step and the
// partial int32 sums are added in shared memory; epilogue 1 (scale, b1, LUT) and the requantization of
// h run in registers; layer 2 (8 -> 1) is an exact int32 sum over the
// quad of threads that holds the row (shuffles), then epilogue 2.  One
// launch where the two-layer path took two GEMMs and eight elementwise
// launches, with the same IEEE steps, so bit-equal to it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 16;   // bytes added to every shared-memory row

struct Epilogue {
  float scale, lo, range, top;
  const float* lut;
  int apply_lut;

  __device__ __forceinline__ float operator()(int acc, float bias,
                                              bool has_bias) const {
    float y = __fmul_rn(__int2float_rn(acc), scale);
    if (has_bias) y = __fadd_rn(y, bias);
    if (apply_lut) {
      float t = __fmul_rn(__fdiv_rn(__fsub_rn(y, lo), range), top);
      t = fminf(fmaxf(t, 0.f), top);
      y = lut[__float2int_rz(t)];
    }
    return y;
  }
};

// quantize_static: round(x * f32(1 / f32(scale))) half to even, clamped
__device__ __forceinline__ int quantize(float x, float inv_scale, float qmax) {
  const float q = rintf(__fmul_rn(x, inv_scale));
  return static_cast<int>(fminf(fmaxf(q, -qmax), qmax));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) |
         ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) |
         (static_cast<uint32_t>(d) << 24);
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A (16 x 32, row) * B (32 x 8, col), int8 in, int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragments of one k32 step.  A at `a` (row-major, lda bytes a row, the
// tile's first row), B at `b` (k-major: row j holds column j's k values).
// lane = 4 * g + t: A rows g and g + 8, bytes 4t.. and 16 + 4t..; B
// column g, the same bytes.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const int8_t* p,
                                       int lda, int g, int t) {
  a[0] = lds32(p + g * lda + 4 * t);
  a[1] = lds32(p + (g + 8) * lda + 4 * t);
  a[2] = lds32(p + g * lda + 16 + 4 * t);
  a[3] = lds32(p + (g + 8) * lda + 16 + 4 * t);
}

__device__ __forceinline__ void load_b(uint32_t (&b)[2], const int8_t* p,
                                       int ldb, int g, int t) {
  b[0] = lds32(p + g * ldb + 4 * t);
  b[1] = lds32(p + g * ldb + 16 + 4 * t);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// The general GEMM
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int BK_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int MT = BM / WM / 16;   // m16 tiles of a warp
  static constexpr int NT = BN / WN / 8;    // n8 tiles of a warp
  static constexpr int LDA = BK + kPad;     // x rows and k-major w rows
  static_assert(BK % 32 == 0 && BN % 8 == 0 && MT >= 1 && NT >= 1, "tile");
};

using Wide = Tile<64, 128, 64, 2, 4>;     // n > 8
using Narrow = Tile<64, 8, 128, 4, 1>;    // n <= 8

template <class C>
__global__ void __launch_bounds__(C::kThreads)
    quant_matmul_kernel(const int8_t* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ bias, Epilogue epi, int m,
                        int k, int n, int vec_x, int vec_w,
                        float* __restrict__ out) {
  __shared__ __align__(16) int8_t As[2][C::BM * C::LDA];
  __shared__ __align__(16) int8_t Ws[2][C::BK * C::BN];   // w as it comes
  __shared__ __align__(16) int8_t Bs[C::BN * C::LDA];     // w k-major

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;

  auto load = [&](int s, int k0) {
    if (vec_x) {
      for (int c = tid; c < C::BM * C::BK / 16; c += C::kThreads) {
        const int r = c / (C::BK / 16), col = (c % (C::BK / 16)) * 16;
        const bool ok = m0 + r < m && k0 + col < k;
        cp_async16(&As[s][r * C::LDA + col],
                   ok ? x + static_cast<size_t>(m0 + r) * k + k0 + col : x,
                   ok);
      }
    } else {
      for (int e = tid; e < C::BM * C::BK; e += C::kThreads) {
        const int r = e / C::BK, col = e % C::BK;
        As[s][r * C::LDA + col] =
            (m0 + r < m && k0 + col < k)
                ? x[static_cast<size_t>(m0 + r) * k + k0 + col] : 0;
      }
    }
    if (vec_w) {
      for (int c = tid; c < C::BK * C::BN / 16; c += C::kThreads) {
        const int r = c / (C::BN / 16), col = (c % (C::BN / 16)) * 16;
        const bool ok = k0 + r < k && n0 + col < n;
        cp_async16(&Ws[s][r * C::BN + col],
                   ok ? w + static_cast<size_t>(k0 + r) * n + n0 + col : w,
                   ok);
      }
    } else {
      for (int e = tid; e < C::BK * C::BN; e += C::kThreads) {
        const int r = e / C::BN, col = e % C::BN;
        Ws[s][r * C::BN + col] =
            (k0 + r < k && n0 + col < n)
                ? w[static_cast<size_t>(k0 + r) * n + n0 + col] : 0;
      }
    }
    cp_async_commit();
  };

  int acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int n_k = (k + C::BK - 1) / C::BK;
  load(0, 0);
  for (int it = 0; it < n_k; ++it) {
    const int s = it & 1;
    if (it + 1 < n_k) {
      load(s ^ 1, (it + 1) * C::BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // w (k, n) row-major -> k-major: each 4 x 4 byte block transposed by
    // byte permutes
    for (int blk = tid; blk < (C::BK / 4) * (C::BN / 4);
         blk += C::kThreads) {
      const int k4 = (blk / (C::BN / 4)) * 4, n4 = (blk % (C::BN / 4)) * 4;
      const int8_t* src = &Ws[s][k4 * C::BN + n4];
      const uint32_t r0 = lds32(src), r1 = lds32(src + C::BN),
                     r2 = lds32(src + 2 * C::BN), r3 = lds32(src + 3 * C::BN);
      const uint32_t lo01 = __byte_perm(r0, r1, 0x5140),
                     lo23 = __byte_perm(r2, r3, 0x5140),
                     hi01 = __byte_perm(r0, r1, 0x7362),
                     hi23 = __byte_perm(r2, r3, 0x7362);
      int8_t* dst = &Bs[n4 * C::LDA + k4];
      *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + C::LDA) =
          __byte_perm(lo01, lo23, 0x7632);
      *reinterpret_cast<uint32_t*>(dst + 2 * C::LDA) =
          __byte_perm(hi01, hi23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 3 * C::LDA) =
          __byte_perm(hi01, hi23, 0x7632);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 32) {
      uint32_t a[C::MT][4], b[C::NT][2];
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
        load_a(a[i], &As[s][(wm * C::MT + i) * 16 * C::LDA + kk], C::LDA, g,
               t);
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
        load_b(b[j], &Bs[(wn * C::NT + j) * 8 * C::LDA + kk], C::LDA, g, t);
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();          // stage s and Bs free for the next copies
  }

  // accumulator: d0, d1 at row g, columns 2t, 2t + 1; d2, d3 at row g + 8
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + (wm * C::MT + i) * 16 + g + (e >> 1) * 8;
        const int col = n0 + (wn * C::NT + j) * 8 + 2 * t + (e & 1);
        if (row < m && col < n)
          out[static_cast<size_t>(row) * n + col] =
              epi(acc[i][j][e], bias != nullptr ? bias[col] : 0.f,
                  bias != nullptr);
      }
}

template <class C>
int launch_gemm(const int8_t* x, const int8_t* w, const float* bias,
                const Epilogue& epi, int m, int k, int n, float* out,
                cudaStream_t stream) {
  const int vec_x = k % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = n % 16 == 0 && C::BN % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  dim3 grid((m + C::BM - 1) / C::BM, (n + C::BN - 1) / C::BN);
  quant_matmul_kernel<C><<<grid, C::kThreads, 0, stream>>>(
      x, w, bias, epi, m, k, n, vec_x, vec_w, out);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The 400-8-1 NN in one launch
// ---------------------------------------------------------------------------

constexpr int kNnRows = 16;                 // rows of a block: one m16 tile
constexpr int kNnWarps = 4;
constexpr int kNnThreads = 32 * kNnWarps;
constexpr int kHidden = 8;                  // n_hidden: mma's n8
constexpr int kNnUnroll = 16;     // float4 loads in flight a thread: 16 rows
                                  // of up to 512 inputs in one round

__global__ void __launch_bounds__(kNnThreads)
    quant_nn_kernel(const float* __restrict__ x,
                    const int8_t* __restrict__ w1t,
                    const float* __restrict__ b1,
                    const int8_t* __restrict__ w2,
                    const float* __restrict__ b2, Epilogue epi1,
                    Epilogue epi2, int m, int k, float inv_sx, float inv_sh,
                    float qmax, float* __restrict__ out) {
  extern __shared__ __align__(16) int8_t nn_smem[];
  const int kp = (k + 31) / 32 * 32;          // k zero-padded to 32
  const int ldw = kp + kPad;
  // x tile as int8, flat: row r at r * k (k % 4 == 0); 32 bytes of slack
  // for the last row's padded k-step (w1 is zero there)
  int8_t* Xq = nn_smem;
  int8_t* W1 = Xq + (kNnRows * k + 32 + 15) / 16 * 16;     // [8][ldw]
  int* red = reinterpret_cast<int*>(W1 + kHidden * ldw);   // [warps][32][4]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kNnRows;

  // the tile's rows are one contiguous range of 16 k floats; k % 4 == 0,
  // so a float4 lies wholly inside or wholly past the last row (rows past
  // m quantize zeros).  A round's loads all start first; w1 is
  // staged under them.
  const int n4 = kNnRows * k / 4;
  const int valid4 = (min(m - m0, kNnRows) * k) / 4;
  const float4* x4 =
      reinterpret_cast<const float4*>(x + static_cast<size_t>(m0) * k);
  for (int c0 = 0; c0 < n4; c0 += kNnThreads * kNnUnroll) {
    float4 v[kNnUnroll];
#pragma unroll
    for (int u = 0; u < kNnUnroll; ++u) {
      const int c = c0 + u * kNnThreads + tid;
      v[u] = c < valid4 ? __ldg(x4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (c0 == 0) {
      // w1, k-major and zero-padded to kp on the host: 16-byte copies
      for (int c = tid; c < kHidden * kp / 16; c += kNnThreads) {
        const int j = c / (kp / 16), col = (c % (kp / 16)) * 16;
        *reinterpret_cast<uint4*>(W1 + j * ldw + col) =
            __ldg(reinterpret_cast<const uint4*>(w1t + j * kp + col));
      }
      if (tid < 8) reinterpret_cast<uint32_t*>(Xq + kNnRows * k)[tid] = 0;
    }
#pragma unroll
    for (int u = 0; u < kNnUnroll; ++u) {
      const int c = c0 + u * kNnThreads + tid;
      if (c < n4)
        reinterpret_cast<uint32_t*>(Xq)[c] =
            pack4(quantize(v[u].x, inv_sx, qmax),
                  quantize(v[u].y, inv_sx, qmax),
                  quantize(v[u].z, inv_sx, qmax),
                  quantize(v[u].w, inv_sx, qmax));
    }
  }
  __syncthreads();

  // layer 1: warp w takes k-steps w, w + 4, ...
  int acc[4] = {0, 0, 0, 0};
  for (int kk = 32 * warp; kk < kp; kk += 32 * kNnWarps) {
    uint32_t a[4], b[2];
    load_a(a, Xq + kk, k, g, t);
    load_b(b, W1 + kk, ldw, g, t);
    mma_s8(acc, a, b);
  }
  if (warp > 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[((warp - 1) * 32 + lane) * 4 + e] = acc[e];
  }
  __syncthreads();
  if (warp > 0) return;
#pragma unroll
  for (int wi = 0; wi < kNnWarps - 1; ++wi)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += red[(wi * 32 + lane) * 4 + e];

  // epilogue 1 and the requantized hidden layer; this thread holds rows
  // g (acc[0..1]) and g + 8 (acc[2..3]), hidden units 2t and 2t + 1
  const int w2a = w2[2 * t], w2b = w2[2 * t + 1];
  int part[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int ha = quantize(epi1(acc[2 * half], b1[2 * t], true), inv_sh, qmax);
    const int hb = quantize(epi1(acc[2 * half + 1], b1[2 * t + 1], true),
                            inv_sh, qmax);
    part[half] = ha * w2a + hb * w2b;
  }
  // layer 2: the exact int32 sum over the quad
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    part[half] += __shfl_xor_sync(0xffffffffu, part[half], 1);
    part[half] += __shfl_xor_sync(0xffffffffu, part[half], 2);
  }
  if (t == 0) {
    const float bias2 = b2[0];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + g + 8 * half;
      if (row < m) out[row] = epi2(part[half], bias2, true);
    }
  }
}

Epilogue make_epilogue(float scale, const float* lut, int entries,
                       int apply_lut, float lo, float range) {
  return Epilogue{scale, lo, range, static_cast<float>(entries - 1), lut,
                  apply_lut};
}

}  // namespace

extern "C" int repro_quant_matmul(const int8_t* x, const int8_t* w,
                                  const float* bias, const float* lut,
                                  int entries, int m, int k, int n,
                                  float scale, int apply_lut, float lo,
                                  float range, float* out,
                                  cudaStream_t stream) {
  if (m <= 0 || n <= 0) return 0;
  const Epilogue epi = make_epilogue(scale, lut, entries, apply_lut, lo,
                                     range);
  if (n <= Narrow::BN)
    return launch_gemm<Narrow>(x, w, bias, epi, m, k, n, out, stream);
  return launch_gemm<Wide>(x, w, bias, epi, m, k, n, out, stream);
}

// y (m,) = nn_forward_quantized(x (m, k) f32): w1t (8, kp) int8, w1
// transposed and zero-padded to kp = k rounded up to 32, b1 (8,), w2 (8, 1)
// int8, b2 (1,); scale1 = f32(scale_x * scale_w1), scale2 = f32(scale_h *
// scale_w2), inv_sx / inv_sh = f32(1 / f32(scale)).  k must be a multiple
// of 4, x and w1t 16-byte aligned.
extern "C" int repro_quant_nn(const float* x, const int8_t* w1t,
                              const float* b1, const int8_t* w2,
                              const float* b2, const float* lut, int entries,
                              int m, int k, float inv_sx, float scale1,
                              float inv_sh, float scale2, float qmax,
                              float lo, float range, float* out,
                              cudaStream_t stream) {
  if (m <= 0) return 0;
  if (k <= 0 || k % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w1t) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp = (k + 31) / 32 * 32;
  const size_t smem = (kNnRows * k + 32 + 15) / 16 * 16 +
                      kHidden * (kp + kPad) +
                      sizeof(int) * (kNnWarps - 1) * 32 * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        quant_nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Epilogue epi1 = make_epilogue(scale1, lut, entries, 1, lo, range);
  const Epilogue epi2 = make_epilogue(scale2, lut, entries, 1, lo, range);
  const unsigned blocks = static_cast<unsigned>((m + kNnRows - 1) / kNnRows);
  quant_nn_kernel<<<blocks, kNnThreads, smem, stream>>>(
      x, w1t, b1, w2, b2, epi1, epi2, m, k, inv_sx, inv_sh, qmax, out);
  return static_cast<int>(cudaGetLastError());
}
