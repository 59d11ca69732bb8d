// 3xTF32 products on mma.sync m16n8k8, shared by the WKV kernels
// (csrc/rwkv_scan.cu's forward, csrc/rwkv_scan_bwd.cu's backward) and the
// float32 flash-attention backward (csrc/flash_attention_bwd.cu, tf32x3),
// and the 16-byte cp.async they use to stage their tiles.  Each float32
// operand is split into a TF32 high part and the remainder; the product of
// the two remainders is dropped: about float32's accuracy.

#pragma once

#include <cuda_runtime.h>

namespace tf32 {

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// x = hi + lo: hi is x cut to TF32's 10 mantissa bits (exact), lo the
// exact remainder, of which the mma reads the top 10 mantissa bits
// (relative error of the pair below 2^-21).  Cutting instead of
// cvt.rna.tf32.f32 takes one LOP3 where the rounding takes several.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// x = hi + lo with hi x rounded to TF32's 10 mantissa bits (to nearest,
// ties away from zero: add half a unit of the cut, then cut) and lo the
// exact remainder, |lo| at most half of hi's last bit where `split`'s may
// reach all of it; the mma reads lo's top 10 mantissa bits, so the pair
// errs half as much as `split`'s.  An IADD more than `split`.
__device__ __forceinline__ void split_rn(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 8, row-major at a[row * stride + col]) of rows r0..,
// columns c0..; lane = 4 g + q holds (g, q), (g + 8, q), (g, q + 4),
// (g + 8, q + 4).  With transposed, the element (row, col) is read at
// a[col * stride + row].
template <bool kTransposed>
__device__ __forceinline__ void a_frag(const float* a, int stride, int r0,
                                       int c0, unsigned (&hi)[4],
                                       unsigned (&lo)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int rows[4] = {r0 + g, r0 + g + 8, r0 + g, r0 + g + 8};
  const int cols[4] = {c0 + q, c0 + q, c0 + q + 4, c0 + q + 4};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split(kTransposed ? a[cols[e] * stride + rows[e]]
                      : a[rows[e] * stride + cols[e]],
          hi[e], lo[e]);
}

// c += A B on 3xTF32, B (8 x 8) at b[row * stride + col], rows k0..,
// columns n0..; lane (g, q) holds (q, g) and (q + 4, g).  With
// kTransposed, the element (row, col) is read at b[col * stride + row].
template <bool kTransposed = false>
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], const float* b,
                                     int stride, int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  unsigned bh0, bl0, bh1, bl1;
  split(kTransposed ? b[(n0 + g) * stride + k0 + q]
                    : b[(k0 + q) * stride + n0 + g], bh0, bl0);
  split(kTransposed ? b[(n0 + g) * stride + k0 + q + 4]
                    : b[(k0 + q + 4) * stride + n0 + g], bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// c += A B on one TF32 term, as mma_tf32 but not volatile: the compiler
// may move independent products between one accumulator's dependent ones
__device__ __forceinline__ void mma_acc(float (&c)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = A B on one TF32 term, from zero sums (c's old value is not read)
__device__ __forceinline__ void mma_zero(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// A 16-byte cp.async that writes 16 zero bytes instead when !valid (a
// source size of 0 reads nothing)
__device__ __forceinline__ void cp_async16_zfill(float* smem,
                                                 const float* gmem,
                                                 bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tf32
