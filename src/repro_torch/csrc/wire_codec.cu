// Offload wire codec for Hopper: block-scaled quantize + bit-pack
// (encode) and unpack + rescale (decode) at 4, 8 and 16 bits.
//
// Replaces the TPU kernels src/repro/kernels/wire_codec/kernel.py:52
// (wire_encode_pallas; _encode_kernel at :25) and :75
// (wire_decode_pallas; _decode_kernel at :39), and the 16-bit byte split
// that the JAX package leaves to its oracle (ops.py:40).  Semantics are
// those of kernels/wire_codec/ref.py, bit for bit:
//   scale = absmax(block) * r,  r = float32(1) / float32(qmax) from the host
//           (the reciprocal multiply XLA makes of `/ qmax` under jit; a
//           true division rounds some scales the other way)
//   scale = 1 where it is 0
//   q     = clamp(rint(x / scale), -qmax, qmax)   (true division, ties even)
//   bits=8: one byte per value; bits=4: nibble pairs, low nibble first;
//   bits=16: little-endian int16 as two bytes.
//   decode: value = float(q) * scale, one rounding.
//
// What bounds it on the card: bytes.  Encode reads 4 B per value and
// writes bits/8 B per value plus 4 B per 256-value block; decode the
// reverse.  At the sensor cut (6,138 blocks, 8 bits) that is 7.9 MB, 2.4 us
// at 3.35 TB/s; the few float operations per value are nothing beside it.
//
// Design: encode runs one CUDA block of 256 threads per payload block; the
// absmax is a warp-shuffle max, then a shared-memory max over the 8 warps,
// with a max that keeps NaN (as torch.amax does; fmaxf would drop it).
// Each thread then quantizes and packs the bytes it owns, building each
// byte as uint8 so that the wrap to int8 is defined.  Decode runs one
// thread per packed byte (per byte pair at 16 bits).  The library is built
// without --use_fast_math and with -fmad=false; division and multiply are
// the explicit IEEE intrinsics.  Both kernels are simple and correct
// first: vectorised 16-byte loads and fusing the codec into the producing
// stage are the later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float nan_max(float a, float b) {
  // NaN wins, as in torch.amax
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ int quantize(float x, float scale, float qmax) {
  float r = rintf(__fdiv_rn(x, scale));
  // comparisons keep NaN as NaN, like torch.clamp; the cast then gives 0,
  // as torch's float -> int32 cast does on the card
  r = r < -qmax ? -qmax : (r > qmax ? qmax : r);
  return static_cast<int>(r);
}

__global__ void wire_encode_kernel(const float* __restrict__ x,
                                   uint8_t* __restrict__ packed,
                                   float* __restrict__ scales, int block,
                                   int bits, float qmax, float inv_qmax) {
  __shared__ float warp_max[kThreads / 32];
  __shared__ float block_scale;
  const float* src = x + static_cast<size_t>(blockIdx.x) * block;
  const int row_bytes = block * bits / 8;
  uint8_t* dst = packed + static_cast<size_t>(blockIdx.x) * row_bytes;

  float m = 0.f;
  for (int i = threadIdx.x; i < block; i += blockDim.x)
    m = nan_max(m, fabsf(src[i]));
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_max[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = warp_max[0];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
      b = nan_max(b, warp_max[w]);
    float s = __fmul_rn(b, inv_qmax);
    if (s == 0.f) s = 1.f;
    block_scale = s;
    scales[blockIdx.x] = s;
  }
  __syncthreads();
  const float scale = block_scale;

  if (bits == 8) {
    for (int i = threadIdx.x; i < block; i += blockDim.x)
      dst[i] = static_cast<uint8_t>(quantize(src[i], scale, qmax) & 0xFF);
  } else if (bits == 4) {
    for (int j = threadIdx.x; j < block / 2; j += blockDim.x) {
      const int lo = quantize(src[2 * j], scale, qmax) & 0xF;
      const int hi = quantize(src[2 * j + 1], scale, qmax) & 0xF;
      dst[j] = static_cast<uint8_t>(lo | (hi << 4));
    }
  } else {  // 16
    for (int i = threadIdx.x; i < block; i += blockDim.x) {
      const int q = quantize(src[i], scale, qmax);
      dst[2 * i] = static_cast<uint8_t>(q & 0xFF);
      dst[2 * i + 1] = static_cast<uint8_t>((q >> 8) & 0xFF);
    }
  }
}

__global__ void wire_decode_kernel(const uint8_t* __restrict__ packed,
                                   const float* __restrict__ scales,
                                   float* __restrict__ out, long long units,
                                   int units_per_row, int block, int bits) {
  const long long u = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (u >= units) return;
  const long long row = u / units_per_row;
  const int col = static_cast<int>(u - row * units_per_row);
  const float scale = scales[row];
  float* dst = out + row * block;
  if (bits == 8) {
    const int v = static_cast<int>(packed[u] & 0xFF);
    dst[col] = __fmul_rn(static_cast<float>(v - ((v & 0x80) << 1)), scale);
  } else if (bits == 4) {
    const int p = static_cast<int>(packed[u] & 0xFF);
    int lo = p & 0xF, hi = (p >> 4) & 0xF;
    lo = lo - ((lo & 8) << 1);
    hi = hi - ((hi & 8) << 1);
    dst[2 * col] = __fmul_rn(static_cast<float>(lo), scale);
    dst[2 * col + 1] = __fmul_rn(static_cast<float>(hi), scale);
  } else {  // 16: one unit per byte pair
    const int v = static_cast<int>(packed[2 * u] & 0xFF) |
                  (static_cast<int>(packed[2 * u + 1] & 0xFF) << 8);
    dst[col] = __fmul_rn(static_cast<float>(v - ((v & 0x8000) << 1)), scale);
  }
}

int units_per_row_of(int block, int bits) {
  return bits == 4 ? block / 2 : block;
}

}  // namespace

extern "C" int repro_wire_encode(const float* x, int8_t* packed,
                                 float* scales, int n_blocks, int block,
                                 int bits, float qmax, float inv_qmax,
                                 cudaStream_t stream) {
  if (n_blocks <= 0) return 0;
  wire_encode_kernel<<<n_blocks, kThreads, 0, stream>>>(
      x, reinterpret_cast<uint8_t*>(packed), scales, block, bits, qmax,
      inv_qmax);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_wire_decode(const int8_t* packed, const float* scales,
                                 float* out, int n_blocks, int block,
                                 int bits, cudaStream_t stream) {
  if (n_blocks <= 0) return 0;
  const int per_row = units_per_row_of(block, bits);
  const long long units = static_cast<long long>(n_blocks) * per_row;
  const long long grid = (units + kThreads - 1) / kThreads;
  wire_decode_kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      reinterpret_cast<const uint8_t*>(packed), scales, out, units, per_row,
      block, bits);
  return static_cast<int>(cudaGetLastError());
}
