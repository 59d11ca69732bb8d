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
// payload block, the absmax through shared memory.
//
// Design of decode, the mirror: one warp per 256-value payload block
// (wire_decode_vec_kernel) over the same grid-stride grid, no division.
// Lane l decodes values 128 c + 4 l .. + 3 of chunk c = 0, 1, each from
// one aligned load of its packed bytes (2 at 4 bits, 4 at 8, 8 at 16: a
// warp reads 64 / 128 / 256 contiguous bytes a chunk), and writes each
// chunk's 4 values as one float4 streaming store (__stcs), so that each
// store is 512 contiguous bytes a warp.  Lane 0 loads the block's scale and
// a shuffle hands it to the warp.  (8 consecutive values a lane, one load
// and two adjacent float4 stores, left every store instruction writing
// half of each 32-byte sector and lost by 11-20% at a capture field;
// plain stores lost to streaming ones by 1-3% there.)  The wrapper
// (kernels/wire_codec/cuda.py, decode_route) sends any other block size,
// or a packed or output pointer off 16-byte alignment, to the scalar
// kernel (wire_decode_kernel): one thread per packed byte (per byte pair
// at 16 bits).  The library is built without --use_fast_math and with
// -fmad=false; division and multiply are the explicit IEEE intrinsics.

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

// the decode's output store: streaming (evict first), for an output that
// is written once and at a capture field never fits in L2
__device__ __forceinline__ void store_out(float4* p, float4 v) {
  __stcs(p, v);
}

// the decode's lane mapping: a lane decodes 8 / kDecodeChunks consecutive
// values in each of kDecodeChunks chunks of its block (see the design note)
constexpr int kDecodeChunks = 2;
static_assert(kDecodeChunks == 1 || kDecodeChunks == 2,
              "a lane decodes 8 or 2 x 4 values");

// value j of a lane's run, sign-extended from its packed field
template <int BITS>
__device__ __forceinline__ float unpack(uint4 w, int j, float scale) {
  int q;
  if (BITS == 4) {
    q = static_cast<int>(w.x << (28 - 4 * j)) >> 28;   // nibble j, low first
  } else if (BITS == 8) {
    const unsigned word = j < 4 ? w.x : w.y;
    q = static_cast<int>(word << (24 - 8 * (j & 3))) >> 24;
  } else {  // 16: little-endian int16
    const unsigned word = j < 2 ? w.x : (j < 4 ? w.y : (j < 6 ? w.z : w.w));
    q = static_cast<int>(word << (16 - 16 * (j & 1))) >> 16;
  }
  return __fmul_rn(static_cast<float>(q), scale);
}

// the packed bytes of one lane's run: BYTES of them from an aligned load
template <int BYTES>
__device__ __forceinline__ uint4 load_run(const uint8_t* p) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (BYTES == 2) {
    w.x = *reinterpret_cast<const unsigned short*>(p);
  } else if (BYTES == 4) {
    w.x = *reinterpret_cast<const unsigned*>(p);
  } else if (BYTES == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w.x = v.x;
    w.y = v.y;
  } else {
    w = *reinterpret_cast<const uint4*>(p);
  }
  return w;
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
    wire_decode_vec_kernel(const uint8_t* __restrict__ packed,
                           const float* __restrict__ scales,
                           float4* __restrict__ out, int n_blocks) {
  constexpr int kRowBytes = kVecBlock * BITS / 8;
  constexpr int kRun = 8 / kDecodeChunks;            // values a lane a chunk
  constexpr int kRunBytes = kRun * BITS / 8;
  constexpr int kChunkValues = kVecBlock / kDecodeChunks;
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int b = warp; b < n_blocks; b += n_warps) {
    const uint8_t* row = packed + static_cast<size_t>(b) * kRowBytes;
    uint4 w[kDecodeChunks];
#pragma unroll
    for (int c = 0; c < kDecodeChunks; ++c) {
      w[c] = load_run<kRunBytes>(row + (c * kChunkValues + kRun * lane) *
                                           BITS / 8);
    }
    float scale = 0.f;
    if (lane == 0) scale = scales[b];
    scale = __shfl_sync(0xffffffffu, scale, 0);
    float4* dst = out + static_cast<size_t>(b) * (kVecBlock / 4);
#pragma unroll
    for (int c = 0; c < kDecodeChunks; ++c) {
#pragma unroll
      for (int k = 0; k < kRun / 4; ++k) {
        store_out(dst + (c * kChunkValues + kRun * lane) / 4 + k,
                  make_float4(unpack<BITS>(w[c], 4 * k, scale),
                              unpack<BITS>(w[c], 4 * k + 1, scale),
                              unpack<BITS>(w[c], 4 * k + 2, scale),
                              unpack<BITS>(w[c], 4 * k + 3, scale)));
      }
    }
  }
}

int units_per_row_of(int block, int bits) {
  return bits == 4 ? block / 2 : block;
}

// the grid-stride grid of the vector kernels: a warp per payload block, at
// most kVecBlocksPerSm blocks of kThreads a SM
cudaError_t vec_grid(int n_blocks, unsigned* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const long long need =
      (static_cast<long long>(n_blocks) * 32 + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * kVecBlocksPerSm;
  *grid = static_cast<unsigned>(need < most ? need : most);
  return cudaSuccess;
}

cudaError_t launch_encode_vec(const float* x, uint8_t* packed, float* scales,
                              int n_blocks, int bits, float qmax,
                              float inv_qmax, cudaStream_t stream) {
  unsigned grid = 0;
  const cudaError_t err = vec_grid(n_blocks, &grid);
  if (err != cudaSuccess) return err;
  wire_encode_vec_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), packed, scales, n_blocks, bits,
      qmax, inv_qmax);
  return cudaGetLastError();
}

cudaError_t launch_decode_vec(const uint8_t* packed, const float* scales,
                              float* out, int n_blocks, int bits,
                              cudaStream_t stream) {
  unsigned grid = 0;
  const cudaError_t err = vec_grid(n_blocks, &grid);
  if (err != cudaSuccess) return err;
  float4* dst = reinterpret_cast<float4*>(out);
  if (bits == 4) {
    wire_decode_vec_kernel<4><<<grid, kThreads, 0, stream>>>(
        packed, scales, dst, n_blocks);
  } else if (bits == 8) {
    wire_decode_vec_kernel<8><<<grid, kThreads, 0, stream>>>(
        packed, scales, dst, n_blocks);
  } else {
    wire_decode_vec_kernel<16><<<grid, kThreads, 0, stream>>>(
        packed, scales, dst, n_blocks);
  }
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

// vec: the wrapper's route (decode_route), 1 for the vector kernel, which
// takes only 256-value blocks on 16-byte-aligned packed and out pointers
extern "C" int repro_wire_decode(const int8_t* packed, const float* scales,
                                 float* out, int n_blocks, int block,
                                 int bits, int vec, cudaStream_t stream) {
  if (n_blocks <= 0) return 0;
  if (vec) {
    const bool aligned = (reinterpret_cast<uintptr_t>(packed) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    if (block != kVecBlock || !aligned) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(launch_decode_vec(
        reinterpret_cast<const uint8_t*>(packed), scales, out, n_blocks,
        bits, stream));
  }
  const int per_row = units_per_row_of(block, bits);
  const long long units = static_cast<long long>(n_blocks) * per_row;
  const long long grid = (units + kThreads - 1) / kThreads;
  wire_decode_kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      reinterpret_cast<const uint8_t*>(packed), scales, out, units, per_row,
      block, bits);
  return static_cast<int>(cudaGetLastError());
}
