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
// at 3.35 TB/s; at one VR capture field (8 x 2160x3840, 259,200 blocks)
// 332.8 MB, 99 us; the few float operations per value are nothing beside
// it.
//
// Design of encode: one warp per payload block (wire_encode_vec_kernel),
// for blocks of 256 values (every block on the paths) and a 16-byte-
// aligned input: lane l loads values 128 c + 4 l .. + 3 of chunk c = 0, 1
// as one float4, so that each load is 512 contiguous bytes a warp, and
// every value is read once.  The absmax is a butterfly of 5 shuffles with
// a max that keeps NaN (as torch.amax does; fmaxf would drop it); no
// shared memory, no barrier.  The lane then quantizes its values from
// registers and stores them packed as one word: 4 bytes at 8 bits, 2 at 4
// bits (low nibble first), 8 at 16 bits.  A grid-stride loop walks the
// blocks, over a grid of at most 8 blocks of 256 threads a SM (one payload
// block a warp at a time: two, with all their loads issued first, took
// more registers and lost).  Any other block size or alignment takes the
// scalar kernel (wire_encode_kernel): one CUDA block of 256 threads per
// payload block, the absmax through shared memory.  Decode runs one
// thread per packed byte (per byte pair at 16 bits).  The library is
// built without --use_fast_math and with -fmad=false; division and
// multiply are the explicit IEEE intrinsics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecBlock = 256;      // the vector kernel's payload block
constexpr int kChunks = kVecBlock / 128;  // float4 loads a lane
constexpr int kVecBlocksPerSm = 8;  // of kThreads, the grid-stride grid

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

// 4 values -> their packed bits, little-endian, as one word
__device__ __forceinline__ unsigned pack4(const int q[4], int bits) {
  if (bits == 8) {
    return (q[0] & 0xFF) | ((q[1] & 0xFF) << 8) | ((q[2] & 0xFF) << 16) |
           (static_cast<unsigned>(q[3] & 0xFF) << 24);
  }
  return (q[0] & 0xF) | ((q[1] & 0xF) << 4) | ((q[2] & 0xF) << 8) |
         ((q[3] & 0xF) << 12);                       // bits == 4
}

__global__ void __launch_bounds__(kThreads)
    wire_encode_vec_kernel(const float4* __restrict__ x,
                           uint8_t* __restrict__ packed,
                           float* __restrict__ scales, int n_blocks,
                           int bits, float qmax, float inv_qmax) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int b = warp; b < n_blocks; b += n_warps) {
    const float4* src = x + static_cast<size_t>(b) * 32 * kChunks;
    float4 v[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) v[c] = src[32 * c + lane];
    float m = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      m = nan_max(m, fabsf(v[c].x));
      m = nan_max(m, fabsf(v[c].y));
      m = nan_max(m, fabsf(v[c].z));
      m = nan_max(m, fabsf(v[c].w));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    float scale = __fmul_rn(m, inv_qmax);
    if (scale == 0.f) scale = 1.f;
    if (lane == 0) scales[b] = scale;
    uint8_t* row = packed + static_cast<size_t>(b) * (kVecBlock * bits / 8);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int q[4] = {quantize(v[c].x, scale, qmax),
                        quantize(v[c].y, scale, qmax),
                        quantize(v[c].z, scale, qmax),
                        quantize(v[c].w, scale, qmax)};
      const int i = 32 * c + lane;                    // word of the row
      if (bits == 8) {
        reinterpret_cast<unsigned*>(row)[i] = pack4(q, 8);
      } else if (bits == 4) {
        reinterpret_cast<unsigned short*>(row)[i] =
            static_cast<unsigned short>(pack4(q, 4));
      } else {  // 16
        reinterpret_cast<uint2*>(row)[i] = make_uint2(
            (q[0] & 0xFFFF) | (static_cast<unsigned>(q[1] & 0xFFFF) << 16),
            (q[2] & 0xFFFF) | (static_cast<unsigned>(q[3] & 0xFFFF) << 16));
      }
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

cudaError_t launch_encode_vec(const float* x, uint8_t* packed, float* scales,
                              int n_blocks, int bits, float qmax,
                              float inv_qmax, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const long long need =
      (static_cast<long long>(n_blocks) * 32 + kThreads - 1) / kThreads;
  const long long grid =
      need < static_cast<long long>(sms) * kVecBlocksPerSm
          ? need
          : static_cast<long long>(sms) * kVecBlocksPerSm;
  wire_encode_vec_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                           stream>>>(reinterpret_cast<const float4*>(x),
                                     packed, scales, n_blocks, bits, qmax,
                                     inv_qmax);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_wire_encode(const float* x, int8_t* packed,
                                 float* scales, int n_blocks, int block,
                                 int bits, float qmax, float inv_qmax,
                                 cudaStream_t stream) {
  if (n_blocks <= 0) return 0;
  uint8_t* out = reinterpret_cast<uint8_t*>(packed);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(packed) % 16 == 0);
  if (aligned && block == kVecBlock) {
    return static_cast<int>(launch_encode_vec(x, out, scales, n_blocks, bits,
                                              qmax, inv_qmax, stream));
  }
  wire_encode_kernel<<<n_blocks, kThreads, 0, stream>>>(
      x, out, scales, block, bits, qmax, inv_qmax);
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
