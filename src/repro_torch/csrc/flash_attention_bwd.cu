// The backward of causal / sliding-window flash attention, for Hopper.
//
// The backward of row 7 of the kernel table: csrc/flash_attention.cu,
// which replaces src/repro/kernels/flash_attention/kernel.py:87.  The
// reference has no backward kernel: it trains through JAX's autodiff of
// the plain _mha_streaming (src/repro/models/attention.py:104).  Given q,
// k, v, the forward's output o, its cotangent dO and each row's
// log-sum-exp lse (written by the forward when asked), with the forward's
// masks (key j is seen by query i when j <= i and, with a window,
// j > i - window):
//   P  = exp(scale q k^T - lse)          recomputed tile by tile
//   Dl = rowsum(dO o)                     one value per query row
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - Dl)
//   dQ = scale dS K,  dK = scale dS^T Q
// with float32 sums from inputs in q's dtype (bf16 or float32), the
// outputs rounded once to it.
//
// Layout: the model's, q and dQ (B, S, H, D), o and dO (B, S, H, DV), k
// and dK (B, T, KV, D), v and dV (B, T, KV, DV), lse and Dl (B, H, S)
// float32, all contiguous and 16-byte aligned; (D, DV) is (64, 64),
// (128, 128) or MLA's (192, 128) (DeepSeek-V2's queries and keys of 128 +
// 64 with the rope key folded into every head, values of 128), the
// forward's pairs; Dl sums over DV.  Query head h reads kv head h / (H /
// KV), so GQA needs no repeated copy of K and V.  Both designs below are
// templates on the pair (DQK, DV); each pair has its own tiles (`Tiles`,
// in each namespace), which for (64, 64) and (128, 128) are the ones the
// text below describes, and for (192, 128) are cut to fit: half the keys
// of dq's K / V tiles and of dkdv's query tiles in bf16, half the rows
// (keys) of a block in float32.  MLA's training step (DeepSeek-V2's 128
// heads, B 8, S = T = 2048, causal) is 3.575e12 operations: 3.615 ms on
// the bf16 tensor cores, against ~1.6 ms for its bytes.
//
// What bounds it on the card: operations.  At the yi-9b training step (B
// 8, S = T = 2048, H 32, KV 4, D 128, causal) the five products are 2 S T
// D each per (b, h), halved by the mask: 6.9e11 operations, 0.6952 ms on
// the bf16 tensor cores (989 TFLOP/s) against 0.12 ms for the bytes.
//
// No atomics, so a gradient is the same bits on every run: dQ has its own
// pass, and dK / dV sum a kv head's H / KV query heads in a fixed order
// inside one block.  One C call launches two kernels on the stream, dq
// then dkdv; the dq kernel writes Dl, which dkdv reads.
//
// bf16 (tensor_core), FlashAttention-3's shape on the forward's pieces
// (csrc/hopper.cuh): each block is two consumer warpgroups of 64 rows (or
// keys) that share a ring of mbarrier-guarded stages in shared memory,
// filled by TMA (128-byte swizzle; the 4-D maps read GQA and ragged
// lengths in place, positions past the end come back as zeros).  Every
// product is `wgmma` with float32 sums in registers: the score products
// with both operands in shared memory, the accumulating products with P or
// dS as the A operand straight from registers (the accumulator layout of a
// score tile is the A fragment layout) and the other operand through the
// descriptor's transpose bit.  The scale multiplies S in float32 after the
// product, as in the forward.  Only tiles that an edge cuts are masked;
// tiles the mask empties are never visited, and the heaviest blocks run
// first.  There is no producer warp: each of an SM's four schedulers holds
// 16,384 registers, so with a ninth warp (three on one scheduler) ptxas
// allots at most 168 a thread, and dkdv's two accumulators alone take 128
// at D = 128; there it spilled and ptxas serialized its wgmma, setmaxnreg
// or not.  With the two warpgroups alone it may allot 255 (dkdv takes 241,
// dq 220, no spills).  Thread 0 issues every copy: a stage is refilled,
// kStages - 1 tiles ahead, as soon as both warpgroups are done with it.
//
//   dq (one block per kDqBQ = 128 query rows of a (b, h)): Q and dO once,
//   K and V tiles of kDqBK = 128 keys through a kDqStages-deep ring.
//   Before the loop each warpgroup sums its rows' Dl from o and dO in
//   device memory (a quarter of d a thread, in order, then across the
//   quad) while the first tiles land, and writes each row's lse and Dl to
//   a scratch padded to kRowPad rows.  A tile: S = Q K^T and dP = dO V^T,
//   P and dS in registers, dQ += dS K.  dQ is scaled and rounded once.
//
//   dkdv (one block per kKvBK = 128 keys of a (b, kv head)): K and V once,
//   then for the kv head's query heads in order, the query tiles of kKvBQ
//   = 64 rows that its mask leaves: Q and dO by TMA and the tile's lse and
//   Dl by bulk copies from the scratch, all on the stage's mbarrier,
//   through a kKvStages-deep ring.  A tile: S^T = K Q^T and dP^T = V dO^T,
//   P^T and dS^T in registers, dV += P^T dO, dK += dS^T Q; dK and dV are
//   rounded once.  64 query rows keep S^T, dP^T, dK and dV in registers
//   at D = 128 (128 rows would take 256 a thread for those four alone).
//
// P and dS are bf16 operands as two terms, hi = bf16(x) and lo = bf16(x -
// hi), two products with the same B tile (kPTerms, kDsTerms), so they keep
// ~16 significant bits.  Chosen by the card's readings (H100, with
// benchmarks/torch_kernel_variants.py `flash_bwd`, given the plain
// forward's O and lse), by the rule that chose the forward's P: the
// cheapest choice that keeps the card's bounds (2^-7 of each output's max
// |plain|, and 2e-2 + 2e-2 |x| elementwise) with margin.  dQ / dK / dV of
// max |plain|, two terms against one:
//   unit scale, 8 x 2048 x 32/4:  1.59e-3 / 3.97e-3 / 2.10e-3 against
//     3.18e-3 / 3.97e-3 / 4.20e-3;
//   q, k at 30x and v at 9x (yi's random-weight scale), the same shape:
//     3.13e-3 / 4.26e-3 / 3.01e-3 against 6.25e-3 / 4.26e-3 / 3.01e-3,
//     elementwise 5.9 / 4.0 / 0.50 times the bound against 119 / 25 / 0.83;
//   the same scale on the CPU emulation's inputs (2 x 2048 x 8/2):
//     3.68e-3 / 5.59e-3 / 4.44e-3 for both, elementwise 5.7 / 1.5 / 0.35
//     against 31 / 25 / 0.49.
// The readings come in bf16 steps of max |plain|'s binade: the 2^-7 bound
// admits one such step and never two.  At yi's scale dK takes one step
// whatever the terms: the tensor cores sum each k16 step of S exactly and
// truncate toward zero to float32, and at logits of ~1e3 that, not P or dS,
// moves dK's largest entries by a step (tests/test_torch_flash_attention.py
// emulates those sums, `wgmma_sum`, and reads the card's digits).  So the
// margin left there is none in dK for either choice; two terms keep dQ at
// half a step where one term takes a whole one (0.40 against 0.80 of the
// bound) and stay 5-20 times nearer the elementwise bound, which at that
// scale no design on the card meets (the card's checks run at the model's
// own inputs; at unit scale two terms read 0.19-0.31 of it, one term
// 0.38-0.67).  Two terms cost ~25% of the time (2.64
// against 2.03 ms).  So the design runs 10 products where the math needs
// 5: dq's pass recomputes S and dP (4 with dS's two terms), dkdv runs S^T,
// dP^T and two terms each of P^T dO and dS^T Q (6): 1.39 ms at the tensor
// cores' peak at the training shape.
//
// What the ring and the two warpgroups do about the bound: the ring keeps
// the next tiles' loads in flight while the warpgroups multiply, so no
// load waits in the loop once it is full; the two warpgroups share every
// tile in shared memory (one load feeds 128 rows of products), each issues
// its two score products back to back before one wait, and its
// accumulating products the same way, and the exponentials and bf16 splits
// of one run while the other's products occupy the tensor cores.
//
// float32 (tf32x3): the same two kernels' shape on the tensor cores.  Every
// product is mma.sync m16n8k8 in 3xTF32 (csrc/tf32_mma.cuh): each float32
// operand is rounded to a TF32 high part plus the remainder (`split_rn`),
// and a k8 step adds lo(A) hi(B), hi(A) lo(B) and hi(A) hi(B) to the
// float32 sums, so the products keep about 21 of float32's 24 bits where
// one TF32 term keeps 11.  Rounding, not cutting, the high part halves the
// remainder: at the random-weight models' scale (q, k at 30x: logits of
// ~1e3, whose error P takes as it is) the cut reads about twice a float32
// computation's error, the rounding as much as one (tests/test_torch_
// flash_attention_f32_bwd.py emulates both against a float64 backward).
// Everything else is float32 as in the plain backward: P = exp(scale S -
// lse), 0 where masked; dS = P (dP - Dl); Dl summed from o and dO in
// device memory (a quarter of d a lane, in order, then across the quad);
// dQ and dK scaled once at the end.  wgmma is not used: it takes TF32 only with both
// operands K-major in shared memory, and dQ = dS K and dK = dS^T Q read K
// and Q the other way; mma.sync reads any layout.
//
// What bounds it: operations.  The same float32-accurate work as 3xTF32 is
// 3 x 6.9e11 operations at the training shape, 4.17 ms at the tensor
// cores' 495 TFLOP/s (TF32, dense), against 10.26 ms for the float32 CUDA
// cores' 67 TFLOP/s; the design runs 7 products where the math needs 5
// (dq recomputes S and dP), 5.84 ms at that peak.
//
//   dq (one block per kDqRows query rows of a (b, h), 16 a warp): Q and dO
//   resident, K and V tiles of kDqKeys keys through a kDqRing-deep cp.async
//   ring; per tile S = Q K^T, dP = dO V^T, dS in registers, dQ += dS K.
//   Writes the rows' lse and Dl to the scratch, padded to kPad rows, and
//   each row's slot (below).
//
//   dkdv (one block per kKvKeys keys of a (b, kv head), 16 a warp): K and
//   V resident, then for the kv head's query heads in order, the query
//   tiles of kKvRows that its mask leaves, with their rows of the scratch,
//   through a kKvRing-deep ring; per tile S^T = K Q^T, dP^T = V dO^T, P^T
//   and dS^T in registers, dV += P^T dO, dK += dS^T Q.
//
// What the design does about the bound: the ring keeps the next tiles'
// copies in flight while the warps multiply; a block's warps share every
// tile in shared memory; each lane reads its operands as float4s from
// tiles whose 16-byte chunks are XOR-swizzled by row (`swz`), so every read
// of a quarter-warp hits 32 distinct banks whether it runs along a row (the
// score products, contracting over d) or down the rows (the accumulating
// products, contracting over keys or queries).  P and dS never leave the
// registers: a score tile's m16n8 accumulator holds (g, 2q), (g, 2q + 1),
// (g + 8, 2q), (g + 8, 2q + 1), and the k8 A fragment wants (g, q), (g + 8,
// q), (g, q + 4), (g + 8, q + 4); rather than move the values (a shuffle
// in each quad, or a trip through shared memory), the contraction order is
// permuted: logical k = q is row 2q of the k8 step's B rows and k = q + 4
// row 2q + 1, so the accumulator registers are the A fragment as they
// stand.  Only the warps whose rows or keys an edge cuts mask; tiles the
// mask empties are never loaded, warps whose part of a tile is empty skip
// it, and the heaviest blocks run first.
//
// The tensor cores cut each sum toward zero, and over a sum of thousands of
// terms (dK and dV over a kv head's query heads) that bias reached 1.9e-4
// of max |plain|; so every product starts from zero sums, over 16 d of a
// score or over one tile's rows of dQ, dK and dV, and is added to the
// float32 sums rounded to nearest (errors near 1e-6 at the training shape;
// dkdv sums hi hi apart from the two cross terms, `kApart`).
//
// Large logits take the forward's sums.  At the random-weight models'
// scale (yi's layer 0: logits up to ~8e3) P = exp(scale S - lse) moves by
// |scale S| 2^-24 for each ulp of S, so the forward's lse holds only
// against S summed as the forward and the plain backward sum it, one FMA a
// d in order (cuBLAS's float32 products do the same); 3xTF32 sums moved P
// by up to 5e-4 there and dQ, dK, dV by 2.6e-4 of max |plain|.  Where P
// |scale S| > kRedo a lane sums that pair's S and dP again so (`in_order`;
// dS = P (dP - Dl) cancels at such pairs, and with dP's 3xTF32 sums the
// chaotic random-weight training records drifted past their one-ulp
// bound), which at unit scale is almost never and at yi's layer 0 about
// once a row: chains of 128 dependent FMAs that the warp waits on.  dq
// does it and writes the first such pair of each row to the row's slot in
// the scratch (its key, S and dP), and dkdv takes the sums from there
// instead of summing them again (the same bits: the same chains).
//
// What bounds it now, as measured on the H100 (benchmarks/torch_kernel_
// variants.py `mma_tf32` and `flash_bwd_f32`): mma.sync in TF32 reaches
// ~317 TFLOP/s on the card, 64% of wgmma's 495 (6.7 clocks a product a
// scheduler from two independent sums a warp), which puts the 7 products
// at 9.4 ms; with one dependent sum a warp at two warps a scheduler it
// takes 13.9 clocks, and these kernels take 13-15, with ~4 other
// instructions a product (loads, splits, the sums' adds) to issue besides.
// dkdv's dK and dV take 128 registers a thread at D = 128 and the resident
// tiles most of the shared memory, so an SM holds 8 warps.  At the
// random-weight scale the chains of dq cost ~1.1 ms more.  Of the A/B's
// variants, dkdv's sums apart, the loop over d kept rolled and a ring
// three deep read fastest or within noise of it; the scores' sums split
// likewise, one score product at a time, the loop over d unrolled, the
// high parts cut, tiles of 16 or 64 and P and dS through shared memory
// read the same or slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace tf32x3 {  // the float32 kernels

using tf32::cp_async16_zfill;
using tf32::cp_async_commit;
using tf32::cp_async_wait;
using tf32::mma_acc;
using tf32::mma_zero;
using tf32::split_rn;

constexpr int kDqRing = 3;      // dq: K / V ring depth
constexpr int kKvRing = 3;      // dkdv: Q / dO ring depth
constexpr int kPad = 128;       // the lse / Dl scratch pads S to this
// planes of a (b, h)'s rows in the scratch: lse, Dl, then the row's slot:
// the key of a pair whose S and dP dq summed in order (-1: none), its S
// and its dP
constexpr int kRowPlanes = 5;
// P |scale S| above which a pair's S and dP are summed again the
// forward's way (`in_order`): below it the 3xTF32 sums' few ulps move P by
// under 2^-20
constexpr float kRedo = 1.f;

// The tiles of a (DQK, DV) pair, DQK the width of Q and K, DV of V, O and
// dO: dq's query rows a block (16 a warp) and keys of a K / V tile, dkdv's
// keys a block (16 a warp) and query rows of a Q / dO tile.
template <int DQK, int DV>
struct Tiles {
  static constexpr int kDqRows = 128;
  static constexpr int kDqKeys = 32;
  static constexpr int kKvKeys = 128;
  static constexpr int kKvRows = 32;
};

// MLA's (192, 128): at 128 rows (keys) a block the resident Q and dO (K
// and V) and the ring would take 286,720 B (288,640 B) of the 232,448 a
// block may have, so a block takes 64, four warps (204,800 and 206,720
// B); the tiles in the ring stay 32 wide.  ptxas (-Xptxas -v, CUDA 12.9,
// sm_90a): dq and dkdv 255 registers, with 152 and 384 B of spill stores
// (116 and 256 B of loads) for dQ's 96 and dK's 96 + dV's 64 floats a
// thread; the (128, 128) dkdv spills 216 B and the (64, 64) one 12 B.
// The spills' cost is not measured apart: row 7hmla reads 157 ms against
// its 20.7 ms bound at 8 x 4000 x 32 heads (PERF.md §6).
template <>
struct Tiles<192, 128> {
  static constexpr int kDqRows = 64;
  static constexpr int kDqKeys = 32;
  static constexpr int kKvKeys = 64;
  static constexpr int kKvRows = 32;
};

// Shared memory in bytes.  dq: Q (kDqRows rows of DQK), dO (kDqRows of
// DV), then K[kDqRing] (kDqKeys of DQK), V[kDqRing] (kDqKeys of DV).
// dkdv: K, V (kKvKeys rows), then per stage Q, dO (kKvRows rows) and the
// rows' kRowPlanes planes of the scratch (kKvRows floats each).
template <int DQK, int DV>
constexpr size_t dq_smem() {
  return 4 * (Tiles<DQK, DV>::kDqRows * (DQK + DV) +
              kDqRing * Tiles<DQK, DV>::kDqKeys * (DQK + DV));
}

template <int DQK, int DV>
constexpr size_t dkdv_smem() {
  return 4 * (Tiles<DQK, DV>::kKvKeys * (DQK + DV) +
              kKvRing * (Tiles<DQK, DV>::kKvRows * (DQK + DV) +
                         kRowPlanes * Tiles<DQK, DV>::kKvRows));
}

template <int DQK, int DV>
constexpr bool tiles_ok() {
  using T = Tiles<DQK, DV>;
  return kPad % T::kDqRows == 0 && T::kDqRows % T::kKvRows == 0 &&
         T::kDqRows % 16 == 0 && T::kKvKeys % 16 == 0 &&
         T::kDqKeys % 8 == 0 && T::kKvRows % 8 == 0 && T::kKvRows <= 32 &&
         T::kDqKeys <= 32 && kDqRing >= 2 && kKvRing >= 2 &&
         dq_smem<DQK, DV>() <= 232448 && dkdv_smem<DQK, DV>() <= 232448;
}

static_assert(tiles_ok<64, 64>() && tiles_ok<128, 128>() &&
                  tiles_ok<192, 128>(),
              "every row of a dkdv tile below S lies in a dq block; 16 rows "
              "a warp, k8 steps, at most 32 pairs a lane's redo mask; a ring "
              "of at least two; at most 227 KB of shared memory a block");

// Chunk c (4 floats) of tile row r lies at chunk c ^ swz(r).  A score
// product's quarter-warp reads rows 2p, 2p + 1 at four chunks c..c + 3 (c
// a multiple of 4): swz of the two rows differ in bit 2.  An accumulating
// product's reads rows 2i + e (i = 0..3) at chunks 2p, 2p + 1: swz(2i + e)
// takes four values in bits 1-2.  Either way 8 distinct chunks mod 8.
__device__ __forceinline__ int swz(int r) { return (r & 6) ^ ((r & 1) << 2); }

// float offset of (row r, columns c..c + 3) in a swizzled tile, c % 4 == 0
template <int D>
__device__ __forceinline__ int at(int r, int c) {
  return r * D + (((c >> 2) ^ swz(r)) << 2);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void split4(float4 v, unsigned (&hi)[4],
                                       unsigned (&lo)[4]) {
  split_rn(v.x, hi[0], lo[0]);
  split_rn(v.y, hi[1], lo[1]);
  split_rn(v.z, hi[2], lo[2]);
  split_rn(v.w, hi[3], lo[3]);
}

// rows [r0, r0 + n) of one head of a (positions, heads, D) float32 tensor
// into a swizzled tile by 16-byte cp.async; rows at or past `end` are zeros
template <int D, int kThreads>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t row_stride, int r0, int n,
                                          int end) {
  constexpr int C = D / 4;
  for (int i = threadIdx.x; i < n * C; i += kThreads) {
    const int r = i / C, c = 4 * (i % C);
    const bool in = r0 + r < end;
    cp_async16_zfill(dst + at<D>(r, c),
                     in ? src + static_cast<size_t>(r0 + r) * row_stride + c
                        : src,
                     in);
  }
}

// s = X Y^T over DX and t = U W^T over DU for the warp's 16 rows (x0.. of
// X and U) and N columns (rows 0.. of Y and W), all swizzled tiles, in the
// m16n8 accumulator layout: s[j] holds (g, 8j + 2q), (g, 8j + 2q + 1),
// (g + 8, 8j + 2q), (g + 8, 8j + 2q + 1) for lane 4g + q.  d runs in
// blocks of 16 at kk; k8 step h of a block takes d = 16 kk + 4 i + 2 h as
// logical k = i and d + 1 as k = i + 4 (i = 0..3), so that a lane reads
// its A and B values of both steps as one float4 a row.  A block's six
// products start from zero sums and are added to s and t once, rounded to
// nearest (the tensor cores cut each sum toward zero, which over a long
// sum biases it).  Where DX > DU (MLA's) the blocks past DU sum s alone.
template <int DX, int DU, int N>
__device__ __forceinline__ void two_scores(const float* X, const float* Y,
                                           const float* U, const float* W,
                                           int x0, float (&s)[N / 8][4],
                                           float (&t)[N / 8][4]) {
  static_assert(DX >= DU && DU % 16 == 0, "t's blocks are s's first ones");
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = t[j][e] = 0.f;
#pragma unroll 1
  for (int kk = 0; kk < DU / 16; ++kk) {
    const int col = 16 * kk + 4 * q;
    // A of step h: (g, k), (g + 8, k), (g, k + 4), (g + 8, k + 4)
    unsigned xh[2][4], xl[2][4], uh[2][4], ul[2][4];
    {
      unsigned h0[4], l0[4], h8[4], l8[4], m0[4], n0[4], m8[4], n8[4];
      split4(ld4(X + at<DX>(x0 + g, col)), h0, l0);
      split4(ld4(X + at<DX>(x0 + g + 8, col)), h8, l8);
      split4(ld4(U + at<DU>(x0 + g, col)), m0, n0);
      split4(ld4(U + at<DU>(x0 + g + 8, col)), m8, n8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xh[h][0] = h0[2 * h], xh[h][1] = h8[2 * h];
        xh[h][2] = h0[2 * h + 1], xh[h][3] = h8[2 * h + 1];
        xl[h][0] = l0[2 * h], xl[h][1] = l8[2 * h];
        xl[h][2] = l0[2 * h + 1], xl[h][3] = l8[2 * h + 1];
        uh[h][0] = m0[2 * h], uh[h][1] = m8[2 * h];
        uh[h][2] = m0[2 * h + 1], uh[h][3] = m8[2 * h + 1];
        ul[h][0] = n0[2 * h], ul[h][1] = n8[2 * h];
        ul[h][2] = n0[2 * h + 1], ul[h][3] = n8[2 * h + 1];
      }
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      unsigned yh[4], yl[4], wh[4], wl[4];
      split4(ld4(Y + at<DX>(8 * j + g, col)), yh, yl);
      split4(ld4(W + at<DU>(8 * j + g, col)), wh, wl);
      // each step lo(A) hi(B), hi(A) lo(B), hi(A) hi(B); the two sums'
      // products alternate so that no product waits on the one before
      float bs[4], bt[4];
      mma_zero(bs, xl[0], yh[0], yh[1]);
      mma_zero(bt, ul[0], wh[0], wh[1]);
      mma_acc(bs, xh[0], yl[0], yl[1]);
      mma_acc(bt, uh[0], wl[0], wl[1]);
      mma_acc(bs, xh[0], yh[0], yh[1]);
      mma_acc(bt, uh[0], wh[0], wh[1]);
      mma_acc(bs, xl[1], yh[2], yh[3]);
      mma_acc(bt, ul[1], wh[2], wh[3]);
      mma_acc(bs, xh[1], yl[2], yl[3]);
      mma_acc(bt, uh[1], wl[2], wl[3]);
      mma_acc(bs, xh[1], yh[2], yh[3]);
      mma_acc(bt, uh[1], wh[2], wh[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __fadd_rn(s[j][e], bs[e]);
        t[j][e] = __fadd_rn(t[j][e], bt[e]);
      }
    }
  }
#pragma unroll 1
  for (int kk = DU / 16; kk < DX / 16; ++kk) {
    const int col = 16 * kk + 4 * q;
    unsigned xh[2][4], xl[2][4];
    {
      unsigned h0[4], l0[4], h8[4], l8[4];
      split4(ld4(X + at<DX>(x0 + g, col)), h0, l0);
      split4(ld4(X + at<DX>(x0 + g + 8, col)), h8, l8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xh[h][0] = h0[2 * h], xh[h][1] = h8[2 * h];
        xh[h][2] = h0[2 * h + 1], xh[h][3] = h8[2 * h + 1];
        xl[h][0] = l0[2 * h], xl[h][1] = l8[2 * h];
        xl[h][2] = l0[2 * h + 1], xl[h][3] = l8[2 * h + 1];
      }
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      unsigned yh[4], yl[4];
      split4(ld4(Y + at<DX>(8 * j + g, col)), yh, yl);
      float bs[4];
      mma_zero(bs, xl[0], yh[0], yh[1]);
      mma_acc(bs, xh[0], yl[0], yl[1]);
      mma_acc(bs, xh[0], yh[0], yh[1]);
      mma_acc(bs, xl[1], yh[2], yh[3]);
      mma_acc(bs, xh[1], yl[2], yl[3]);
      mma_acc(bs, xh[1], yh[2], yh[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = __fadd_rn(s[j][e], bs[e]);
    }
  }
}

// acc += A Z over N rows of Z, A (16 x N) in two_scores' accumulator
// layout, Z (N x D) a swizzled tile.  k8 step j takes Z's rows 8j..8j + 7
// with a[j] as the A fragment as it stands: logical k = q is row 8j + 2q
// and k = q + 4 row 8j + 2q + 1.  The output columns are permuted so that
// a lane reads its B values as float4s: of a 32-column group cg, n-tile t
// takes column 32 cg + 4 n + t as logical n, so acc[cg][t] holds (g, 32 cg
// + 8q + t), (g, 32 cg + 8q + 4 + t), (g + 8, 32 cg + 8q + t), (g + 8, 32
// cg + 8q + 4 + t).  A group's products over the N rows start from zero
// sums and are added to acc once, rounded to nearest; with kApart hi(A)
// hi(B) is summed apart from the two cross terms (eight chains of dependent
// products where one sum a tile makes four).
template <int D, int N, bool kApart>
__device__ __forceinline__ void accumulate(float (&acc)[D / 32][4][4],
                                           const float (&a)[N / 8][4],
                                           const float* Z) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  unsigned ah[N / 8][4], al[N / 8][4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    split_rn(a[j][0], ah[j][0], al[j][0]);
    split_rn(a[j][2], ah[j][1], al[j][1]);
    split_rn(a[j][1], ah[j][2], al[j][2]);
    split_rn(a[j][3], ah[j][3], al[j][3]);
  }
#pragma unroll
  for (int cg = 0; cg < D / 32; ++cg) {
    // hi(A) hi(B) in part; lo(A) hi(B) and hi(A) lo(B) in cross, or in part
    // before hi hi with one sum; each over the four n-tiles
    float part[4][4], cross[4][4];
    float(&lo)[4][4] = kApart ? cross : part;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      unsigned h0[4], l0[4], h1[4], l1[4];
      split4(ld4(Z + at<D>(8 * j + 2 * q, 32 * cg + 4 * g)), h0, l0);
      split4(ld4(Z + at<D>(8 * j + 2 * q + 1, 32 * cg + 4 * g)), h1, l1);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (j == 0) mma_zero(lo[t], al[j], h0[t], h1[t]);
        else mma_acc(lo[t], al[j], h0[t], h1[t]);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) mma_acc(lo[t], ah[j], l0[t], l1[t]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (kApart && j == 0) mma_zero(part[t], ah[j], h0[t], h1[t]);
        else mma_acc(part[t], ah[j], h0[t], h1[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[cg][t][e] = __fadd_rn(
            acc[cg][t][e],
            kApart ? __fadd_rn(part[t][e], cross[t][e]) : part[t][e]);
  }
}

// acc's rows g (at p0, if ok0) and g + 8 (at p8, if ok8), times `mul`, in
// the column order of `accumulate`
template <int D>
__device__ __forceinline__ void store_rows(float* p0, float* p8, bool ok0,
                                           bool ok8,
                                           const float (&acc)[D / 32][4][4],
                                           float mul) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int cg = 0; cg < D / 32; ++cg)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = 32 * cg + 8 * q + 4 * half;
      if (ok0)
        st4(p0 + c, __fmul_rn(acc[cg][0][half], mul),
            __fmul_rn(acc[cg][1][half], mul), __fmul_rn(acc[cg][2][half], mul),
            __fmul_rn(acc[cg][3][half], mul));
      if (ok8)
        st4(p8 + c, __fmul_rn(acc[cg][0][2 + half], mul),
            __fmul_rn(acc[cg][1][2 + half], mul),
            __fmul_rn(acc[cg][2][2 + half], mul),
            __fmul_rn(acc[cg][3][2 + half], mul));
    }
}

// S = q . k and dP = dO . v of one (query, key) pair as the float32
// forward kernel (csrc/flash_attention.cu, cuda_core) and the plain
// backward's products sum them: one FMA a d, in order.  Q, G (dO) hold the
// query at row qr, K, V the key at row kr, all swizzled tiles.  For the
// few pairs where P is large and the logit large: there P = exp(scale S -
// lse) moves by |scale S| 2^-24 for each ulp of S, and the forward's lse
// holds only against the forward's own S; dS = P (dP - Dl) cancels there,
// so dP is summed the plain backward's way too.  S runs over DX (Q, K), dP
// over DU (dO, V); past DU (MLA's 192 against 128) S's FMAs go on alone,
// in the same order: the float32 forward at (192, 128) sums S one FMA a d
// from d = 0 up, whatever its key tile (csrc/flash_attention.cu).
template <int DX, int DU>
__device__ __forceinline__ float2 in_order(const float* Q, const float* K,
                                           const float* G, const float* V,
                                           int qr, int kr) {
  static_assert(DX >= DU, "dP's d are S's first ones");
  const float *q = Q + qr * DX, *k = K + kr * DX, *g = G + qr * DU,
              *v = V + kr * DU;
  const int sq = swz(qr), sk = swz(kr);
  float s = 0.f, d = 0.f;
  // the next 4 d's loads issued before this 4's FMAs
  float4 a = ld4(q + (sq << 2)), b = ld4(k + (sk << 2));
  float4 u = ld4(g + (sq << 2)), w = ld4(v + (sk << 2));
  for (int c = 1; c <= DU / 4; ++c) {
    const int n = c < DX / 4 ? c : 0;
    const int m = c < DU / 4 ? c : 0;
    const float4 a1 = ld4(q + ((n ^ sq) << 2)), b1 = ld4(k + ((n ^ sk) << 2));
    const float4 u1 = ld4(g + ((m ^ sq) << 2)), w1 = ld4(v + ((m ^ sk) << 2));
    s = __fmaf_rn(a.x, b.x, s);
    s = __fmaf_rn(a.y, b.y, s);
    s = __fmaf_rn(a.z, b.z, s);
    s = __fmaf_rn(a.w, b.w, s);
    d = __fmaf_rn(u.x, w.x, d);
    d = __fmaf_rn(u.y, w.y, d);
    d = __fmaf_rn(u.z, w.z, d);
    d = __fmaf_rn(u.w, w.w, d);
    a = a1, b = b1, u = u1, w = w1;
  }
  for (int c = DU / 4 + 1; c <= DX / 4; ++c) {
    const int n = c < DX / 4 ? c : 0;
    const float4 a1 = ld4(q + ((n ^ sq) << 2)), b1 = ld4(k + ((n ^ sk) << 2));
    s = __fmaf_rn(a.x, b.x, s);
    s = __fmaf_rn(a.y, b.y, s);
    s = __fmaf_rn(a.z, b.z, s);
    s = __fmaf_rn(a.w, b.w, s);
    a = a1, b = b1;
  }
  return make_float2(s, d);
}

// One block: kDqRows query rows of one (b, h), 16 a warp.  Writes the
// rows' planes to `rows` ((B, H, kRowPlanes, S padded to kPad) float32:
// lse, Dl (0 past S), the slot), then dQ.
template <int DQK, int DV>
__global__ void __launch_bounds__(2 * Tiles<DQK, DV>::kDqRows, 1)
    flash_attention_bwd_dq_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const float* __restrict__ o,
                                  const float* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  float* __restrict__ rows,
                                  float* __restrict__ dq, int S, int Tk,
                                  int H, int KV, float scale, int window) {
  constexpr int kDqRows = Tiles<DQK, DV>::kDqRows;
  constexpr int kDqKeys = Tiles<DQK, DV>::kDqKeys;
  constexpr int kThreads = 2 * kDqRows;
  constexpr int kTile = kDqKeys * DQK;       // floats of a K tile
  constexpr int kVTile = kDqKeys * DV;       // and of a V tile
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + kDqRows * DQK;            // dO
  float* Ks = Gs + kDqRows * DV;             // K[kDqRing]
  float* Vs = Ks + kDqRing * kTile;          // V[kDqRing]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int n_qt = (S + kDqRows - 1) / kDqRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * kDqRows;
  // key tiles in which the mask leaves a pair: none past the block's last
  // row; with a window none wholly before k_min, the first key row q0 sees
  const int k_stop = min(Tk, min(S, q0 + kDqRows));
  const int k_min = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_first = k_min / kDqKeys * kDqKeys;
  const int n_tiles =
      k_stop > k_min ? (k_stop - k_first + kDqKeys - 1) / kDqKeys : 0;
  const size_t q_row = static_cast<size_t>(H) * DQK;
  const size_t o_row = static_cast<size_t>(H) * DV;
  const size_t k_row = static_cast<size_t>(KV) * DQK;
  const size_t v_row = static_cast<size_t>(KV) * DV;
  const size_t q_off = (static_cast<size_t>(b) * S * H + h) * DQK;
  const size_t o_off = (static_cast<size_t>(b) * S * H + h) * DV;
  const size_t k_off = (static_cast<size_t>(b) * Tk * KV + kvh) * DQK;
  const size_t v_off = (static_cast<size_t>(b) * Tk * KV + kvh) * DV;

  // K and V tile i into stage i % kDqRing
  auto issue = [&](int i) {
    const int st = i % kDqRing;
    const int k0 = k_first + i * kDqKeys;
    load_tile<DQK, kThreads>(Ks + st * kTile, k + k_off, k_row, k0, kDqKeys,
                             Tk);
    load_tile<DV, kThreads>(Vs + st * kVTile, v + v_off, v_row, k0, kDqKeys,
                            Tk);
  };
  load_tile<DQK, kThreads>(Qs, q + q_off, q_row, q0, kDqRows, S);
  load_tile<DV, kThreads>(Gs, dout + o_off, o_row, q0, kDqRows, S);
  for (int i = 0; i < kDqRing - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;                  // row in an 8-row group
  const int tq = lane & 3;                  // column pair in an 8-column group
  const int x0 = 16 * (tid >> 5);           // the warp's rows in the block
  const int r_lo = q0 + x0;
  const int rl = min(r_lo + 16, S) - 1;     // the warp's last row below S
  const int row = r_lo + g;                 // and row + 8
  const int s_pad = (S + kPad - 1) / kPad * kPad;
  float* rg = rows + static_cast<size_t>(bh) * kRowPlanes * s_pad;

  // Dl = rowsum(dO o) and lse of rows row and row + 8 (0 past S), read
  // while the first tiles land: each lane of a quad sums a quarter of d in
  // order, then the quad adds the four sums (the same bits in each).  Both
  // go to the (b, h)'s rows of the scratch, which dkdv copies from
  float dl[2], ls[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = row + 8 * j;
    float a = 0.f;
    if (r < S) {
      const size_t at0 = o_off + static_cast<size_t>(r) * o_row + tq * (DV / 4);
      const float4* op = reinterpret_cast<const float4*>(o + at0);
      const float4* gp = reinterpret_cast<const float4*>(dout + at0);
#pragma unroll
      for (int c = 0; c < DV / 16; ++c) {
        const float4 ov = op[c], gv = gp[c];
        a = __fmaf_rn(gv.x, ov.x, a);
        a = __fmaf_rn(gv.y, ov.y, a);
        a = __fmaf_rn(gv.z, ov.z, a);
        a = __fmaf_rn(gv.w, ov.w, a);
      }
    }
    a = hopper::quad_sum(a);
    dl[j] = a;
    ls[j] = r < S ? lse[static_cast<size_t>(bh) * S + r] : 0.f;
    if (tq == 0) {                          // r < S padded: every row
      rg[r] = ls[j];
      rg[s_pad + r] = a;
      rg[2 * s_pad + r] = __int_as_float(-1);   // no slot yet
    }
  }
  bool filled[2] = {false, false};          // the rows' slots, in the quad

  float acc[DQK / 32][4][4];                // dQ: rows row, row + 8
#pragma unroll
  for (int cg = 0; cg < DQK / 32; ++cg)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[cg][t][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    // tile it has landed and every warp is done with tile it - 1, whose
    // stage takes tile it - 1 + kDqRing
    cp_async_wait<kDqRing - 2>();
    __syncthreads();
    if (it + kDqRing - 1 < n_tiles) issue(it + kDqRing - 1);
    cp_async_commit();
    const int st = it % kDqRing;
    const int k0 = k_first + it * kDqKeys;
    const int k1 = min(k0 + kDqKeys, Tk) - 1;   // the last key below Tk
    // the warp's rows r_lo..rl against keys k0..k1: skipped where the mask
    // leaves no pair, masked only where an edge cuts
    const bool live =
        r_lo <= rl && k0 <= rl && (window <= 0 || k1 > r_lo - window);
    if (!live) continue;
    const bool edge = k1 > r_lo || k0 + kDqKeys > Tk ||
                      (window > 0 && k0 <= rl - window);
    const float* kt = Ks + st * kTile;
    float sc[kDqKeys / 8][4], dp[kDqKeys / 8][4];
    two_scores<DQK, DV, kDqKeys>(Qs, kt, Gs, Vs + st * kVTile, x0, sc, dp);
    // P = exp(scale S - lse), 0 where masked, into sc; where P takes S's
    // rounding, S and dP again the forward's way (`in_order`); then dS =
    // P (dP - Dl), into sc
    unsigned redo = 0;                      // bit 4j + e
#pragma unroll
    for (int j = 0; j < kDqKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jr = e >> 1;              // row + 8 jr
        bool valid = true;
        if (edge) {
          const int r = row + 8 * jr;
          const int c = k0 + 8 * j + 2 * tq + (e & 1);
          valid = c < Tk && c <= r;
          if (window > 0) valid = valid && c > r - window;
        }
        const float x = __fmul_rn(sc[j][e], scale);
        float p = expf(__fsub_rn(x, ls[jr]));
        if (!valid) p = 0.f;
        if (p * fabsf(x) > kRedo) redo |= 1u << (4 * j + e);
        sc[j][e] = p;
      }
    // the first such pair of each row also goes to the row's slot, where
    // dkdv takes its sums instead of summing them again
    bool cand[2] = {false, false};
    float2 cs[2];
    int ck[2];
    while (redo) {
      const int i = __ffs(redo) - 1;
      redo &= redo - 1;
      const int jr = (i >> 1) & 1;
      const int c = 8 * (i >> 2) + 2 * tq + (i & 1);   // the tile's key
      const float2 sd = in_order<DQK, DV>(Qs, kt, Gs, Vs + st * kVTile,
                                          x0 + g + 8 * jr, c);
      const float p =
          expf(__fsub_rn(__fmul_rn(sd.x, scale), jr ? ls[1] : ls[0]));
#pragma unroll
      for (int n = 0; n < kDqKeys / 2; ++n)
        if (n == i) {
          sc[n >> 2][n & 3] = p;
          dp[n >> 2][n & 3] = sd.y;
        }
      if (!cand[jr]) {
        cand[jr] = true;
        cs[jr] = sd;
        ck[jr] = k0 + c;
      }
    }
#pragma unroll
    for (int jr = 0; jr < 2; ++jr) {
      const unsigned m = __ballot_sync(0xffffffffu, cand[jr] && !filled[jr]);
      const unsigned quad = (m >> (lane & ~3)) & 0xfu;
      if (quad) {                           // the lowest lane of the quad
        if (tq == __ffs(quad) - 1) {
          const int r = row + 8 * jr;
          rg[2 * s_pad + r] = __int_as_float(ck[jr]);
          rg[3 * s_pad + r] = cs[jr].x;
          rg[4 * s_pad + r] = cs[jr].y;
        }
        filled[jr] = true;
      }
    }
#pragma unroll
    for (int j = 0; j < kDqKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[j][e] = __fmul_rn(sc[j][e], __fsub_rn(dp[j][e], dl[e >> 1]));
    accumulate<DQK, kDqKeys, false>(acc, sc, kt);
  }
  cp_async_wait<0>();

  // dQ = scale (dS K), rounded once
  float* qb = dq + q_off + static_cast<size_t>(row) * q_row;
  store_rows<DQK>(qb, qb + 8 * q_row, row < S, row + 8 < S, acc, scale);
}

// One block: kKvKeys keys of one (b, kv head), 16 a warp.  Walks the kv
// head's H / KV query heads in order and, for each, the query tiles its
// mask leaves, accumulating dK and dV.
template <int DQK, int DV>
__global__ void __launch_bounds__(2 * Tiles<DQK, DV>::kKvKeys, 1)
    flash_attention_bwd_dkdv_kernel(const float* __restrict__ q,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    const float* __restrict__ dout,
                                    const float* __restrict__ rows,
                                    float* __restrict__ dk,
                                    float* __restrict__ dv, int S, int Tk,
                                    int H, int KV, float scale, int window) {
  constexpr int kKvKeys = Tiles<DQK, DV>::kKvKeys;
  constexpr int kKvRows = Tiles<DQK, DV>::kKvRows;
  constexpr int kThreads = 2 * kKvKeys;
  constexpr int kTile = kKvRows * DQK;       // floats of a Q tile
  constexpr int kGTile = kKvRows * DV;       // and of a dO tile
  constexpr int kStage = kTile + kGTile + kRowPlanes * kKvRows;  // Q, dO, rows
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kKvKeys * DQK;
  float* ring = Vs + kKvKeys * DV;

  const int bkv = blockIdx.x;
  const int b = bkv / KV;
  const int kvh = bkv - b * KV;
  const int G = H / KV;
  const int k0 = static_cast<int>(blockIdx.y) * kKvKeys;   // heaviest first
  const int s_pad = (S + kPad - 1) / kPad * kPad;
  // query tiles in which the mask leaves a pair: from the tile of row k0;
  // with a window, none at or past the last key + window
  const int q_begin = k0 / kKvRows * kKvRows;
  const int q_end = window > 0 ? min(S, min(Tk, k0 + kKvKeys) - 1 + window) : S;
  const int n_q = q_end > q_begin ? (q_end - q_begin + kKvRows - 1) / kKvRows : 0;
  const int n_iters = G * n_q;
  const size_t q_row = static_cast<size_t>(H) * DQK;
  const size_t o_row = static_cast<size_t>(H) * DV;
  const size_t k_row = static_cast<size_t>(KV) * DQK;
  const size_t v_row = static_cast<size_t>(KV) * DV;
  const size_t k_off = (static_cast<size_t>(b) * Tk * KV + kvh) * DQK;
  const size_t v_off = (static_cast<size_t>(b) * Tk * KV + kvh) * DV;

  // tile i of the walk (query head kvh G + i / n_q) into stage i % kKvRing:
  // Q, dO, and the tile's rows of the dq kernel's scratch (lse, Dl, slot)
  auto issue = [&](int i) {
    float* st = ring + (i % kKvRing) * kStage;
    const int g = i / n_q;
    const int q0 = q_begin + (i - g * n_q) * kKvRows;
    const int h = kvh * G + g;
    const size_t q_off = (static_cast<size_t>(b) * S * H + h) * DQK;
    const size_t o_off = (static_cast<size_t>(b) * S * H + h) * DV;
    load_tile<DQK, kThreads>(st, q + q_off, q_row, q0, kKvRows, S);
    load_tile<DV, kThreads>(st + kTile, dout + o_off, o_row, q0, kKvRows, S);
    const float* src =
        rows + (static_cast<size_t>(b) * H + h) * kRowPlanes * s_pad + q0;
    for (int c = threadIdx.x; c < kRowPlanes * kKvRows / 4; c += kThreads) {
      const int plane = c / (kKvRows / 4), x = 4 * (c % (kKvRows / 4));
      cp_async16_zfill(st + kTile + kGTile + plane * kKvRows + x,
                       src + plane * s_pad + x, true);
    }
  };
  load_tile<DQK, kThreads>(Ks, k + k_off, k_row, k0, kKvKeys, Tk);
  load_tile<DV, kThreads>(Vs, v + v_off, v_row, k0, kKvKeys, Tk);
  for (int i = 0; i < kKvRing - 1; ++i) {
    if (i < n_iters) issue(i);
    cp_async_commit();
  }

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gr = lane >> 2;                  // key in an 8-key group
  const int tq = lane & 3;                   // query pair in an 8-query group
  const int x0 = 16 * (tid >> 5);            // the warp's keys in the block
  const int kw = k0 + x0;
  const int kl = min(kw + 16, Tk) - 1;       // the warp's last key below Tk
  const int key = kw + gr;                   // and key + 8
  float ak[DQK / 32][4][4], av[DV / 32][4][4];  // dK, dV: keys key, key + 8
#pragma unroll
  for (int cg = 0; cg < DQK / 32; ++cg)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ak[cg][t][e] = 0.f;
        if (cg < DV / 32) av[cg][t][e] = 0.f;
      }

  for (int it = 0; it < n_iters; ++it) {
    cp_async_wait<kKvRing - 2>();
    __syncthreads();
    if (it + kKvRing - 1 < n_iters) issue(it + kKvRing - 1);
    cp_async_commit();
    const float* qt = ring + (it % kKvRing) * kStage;
    const float* gt = qt + kTile;
    const float* rs = gt + kGTile;           // lse, Dl, slot key, S, dP
    const int g = it / n_q;
    const int q0 = q_begin + (it - g * n_q) * kKvRows;
    const int q1 = min(q0 + kKvRows, S) - 1;    // the last query below S
    // the warp's keys kw..kl against queries q0..q1: skipped where the mask
    // leaves no pair, masked only where an edge cuts
    const bool live =
        kw <= kl && kw <= q1 && (window <= 0 || kl > q0 - window);
    if (!live) continue;
    const bool edge = kl > q0 || kw + 16 > Tk || q0 + kKvRows > S ||
                      (window > 0 && kw <= q1 - window);
    float sc[kKvRows / 8][4], dp[kKvRows / 8][4];
    two_scores<DQK, DV, kKvRows>(Ks, qt, Vs, gt, x0, sc, dp);
    // P^T = exp(scale S^T - lse), 0 where masked, into sc; where P takes
    // S's rounding, S and dP again the forward's way (`in_order`, or dq's
    // from the query's slot); then dS^T = P^T (dP^T - Dl), into dp
    unsigned redo = 0;                       // bit 4j + e
#pragma unroll
    for (int j = 0; j < kKvRows / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tq + (e & 1);   // the tile's query
        bool valid = true;
        if (edge) {
          const int qr = q0 + c;
          const int kc = key + 8 * (e >> 1);
          valid = kc < Tk && kc <= qr && qr < S;
          if (window > 0) valid = valid && kc > qr - window;
        }
        const float x = __fmul_rn(sc[j][e], scale);
        float p = expf(__fsub_rn(x, rs[c]));
        if (!valid) p = 0.f;
        if (p * fabsf(x) > kRedo) redo |= 1u << (4 * j + e);
        sc[j][e] = p;
      }
    while (redo) {
      const int i = __ffs(redo) - 1;
      redo &= redo - 1;
      const int c = 8 * (i >> 2) + 2 * tq + (i & 1);
      const int kr = x0 + gr + 8 * ((i >> 1) & 1);   // the block's key
      const float2 sd =
          __float_as_int(rs[2 * kKvRows + c]) == k0 + kr
              ? make_float2(rs[3 * kKvRows + c], rs[4 * kKvRows + c])
              : in_order<DQK, DV>(qt, Ks, gt, Vs, c, kr);
      const float p = expf(__fsub_rn(__fmul_rn(sd.x, scale), rs[c]));
#pragma unroll
      for (int n = 0; n < kKvRows / 2; ++n)
        if (n == i) {
          sc[n >> 2][n & 3] = p;
          dp[n >> 2][n & 3] = sd.y;
        }
    }
#pragma unroll
    for (int j = 0; j < kKvRows / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tq + (e & 1);
        dp[j][e] = __fmul_rn(sc[j][e], __fsub_rn(dp[j][e], rs[kKvRows + c]));
      }
    accumulate<DV, kKvRows, true>(av, sc, gt);
    accumulate<DQK, kKvRows, true>(ak, dp, qt);
  }
  cp_async_wait<0>();

  // dK = scale (dS^T Q) and dV, rounded once
  const size_t at_k = k_off + static_cast<size_t>(key) * k_row;
  const size_t at_v = v_off + static_cast<size_t>(key) * v_row;
  store_rows<DQK>(dk + at_k, dk + at_k + 8 * k_row, key < Tk, key + 8 < Tk,
                  ak, scale);
  store_rows<DV>(dv + at_v, dv + at_v + 8 * v_row, key < Tk, key + 8 < Tk,
                 av, 1.f);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int S, int Tk, int H, int KV,
           float scale, int window, cudaStream_t stream) {
  constexpr int kDqRows = Tiles<DQK, DV>::kDqRows;
  constexpr int kKvKeys = Tiles<DQK, DV>::kKvKeys;
  const int n_qt = (S + kDqRows - 1) / kDqRows;
  const int n_kt = (Tk + kKvKeys - 1) / kKvKeys;
  if (n_qt > 65535 || n_kt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto dq_kernel = flash_attention_bwd_dq_kernel<DQK, DV>;
  auto dkdv_kernel = flash_attention_bwd_dkdv_kernel<DQK, DV>;
  cudaError_t err = allow_smem(dq_kernel, dq_smem<DQK, DV>());
  if (err == cudaSuccess)
    err = allow_smem(dkdv_kernel, dkdv_smem<DQK, DV>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* qt = static_cast<const float*>(q);
  const auto* kt = static_cast<const float*>(k);
  const auto* vt = static_cast<const float*>(v);
  const auto* gt = static_cast<const float*>(dout);
  dq_kernel<<<dim3(B * H, n_qt), 2 * kDqRows, dq_smem<DQK, DV>(), stream>>>(
      qt, kt, vt, static_cast<const float*>(o), gt, lse, delta,
      static_cast<float*>(dq), S, Tk, H, KV, scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<<<dim3(B * KV, n_kt), 2 * kKvKeys, dkdv_smem<DQK, DV>(),
                stream>>>(qt, kt, vt, gt, delta, static_cast<float*>(dk),
                          static_cast<float*>(dv), S, Tk, H, KV, scale,
                          window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf32x3

namespace tensor_core {  // the bf16 kernels

using namespace hopper;

constexpr int kDqBQ = 128;      // dq: query rows of a block, 64 a consumer
constexpr int kDqStages = 2;    // dq: K / V ring depth
constexpr int kKvBK = 128;      // dkdv: keys of a block, 64 a consumer
constexpr int kKvStages = 2;    // dkdv: Q / dO ring depth
constexpr int kPTerms = 2;      // bf16 terms of P in dV = P^T dO
constexpr int kDsTerms = 2;     // bf16 terms of dS in dQ = dS K, dK = dS^T Q
constexpr int kRowPad = 128;    // the lse / Dl scratch pads S to this

// The tiles of a (DQK, DV) pair, DQK the width of Q and K, DV of V, O and
// dO: dq's keys of a K / V tile and dkdv's query rows of a Q / dO tile.
template <int DQK, int DV>
struct Tiles {
  static constexpr int kDqBK = 128;
  static constexpr int kKvBQ = 64;
};

// MLA's (192, 128): dq's key tiles of 128 would need 246,824 B of shared
// memory (Q, dO and two stages of K, V), past the 232,448 a block may
// have; tiles of 64 take 164,904 B and halve S and dP a thread (32 floats
// each beside dQ's 96).  dkdv holds dK (96 floats a thread) and dV (64):
// with query tiles of 64, S^T and dP^T would add 64 and take it past the
// 255 registers a thread may have; tiles of 32 add 32, as many as at
// (128, 128), in 124,456 B.  ptxas (-Xptxas -v, CUDA 12.9, sm_90a): dq
// 190 registers, dkdv 245 (220 and 241 at (128, 128)), no spills.
template <>
struct Tiles<192, 128> {
  static constexpr int kDqBK = 64;
  static constexpr int kKvBQ = 32;
};

constexpr int kConsumers = 2;   // consumer warpgroups
constexpr int kThreads = 128 * kConsumers;  // no producer warp (see above)
constexpr float kLog2e = 1.4426950408889634f;

// bytes of one TMA box: `rows` positions x 64 bf16
__host__ __device__ constexpr uint32_t box_bytes(int rows) {
  return static_cast<uint32_t>(rows) * 128;
}

// Shared memory, from a 1024-byte boundary.  dq: Q, dO (kDqBQ rows),
// K[kDqStages], V[kDqStages] (kDqBK rows), Q and K DQK / 64 boxes each,
// dO and V DV / 64, then the mbarriers full[kDqStages], empty[kDqStages]
// and q.
template <int DQK, int DV>
constexpr size_t dq_smem() {
  return 1024 + ((DQK + DV) / 64) *
                    (box_bytes(kDqBQ) +
                     kDqStages * box_bytes(Tiles<DQK, DV>::kDqBK)) +
         8 * (2 * kDqStages + 1);
}

// dkdv: K, V (kKvBK rows), Q[kKvStages], dO[kKvStages] (kKvBQ rows), in
// boxes as dq's, then the stages' rows of lse and Dl (float32), then the
// mbarriers full[kKvStages], empty[kKvStages] and kv.
template <int DQK, int DV>
constexpr size_t dkdv_smem() {
  return 1024 + ((DQK + DV) / 64) *
                    (box_bytes(kKvBK) +
                     kKvStages * box_bytes(Tiles<DQK, DV>::kKvBQ)) +
         kKvStages * 2 * Tiles<DQK, DV>::kKvBQ * 4 + 8 * (2 * kKvStages + 1);
}

template <int DQK, int DV>
constexpr bool tiles_ok() {
  using T = Tiles<DQK, DV>;
  return kRowPad % kDqBQ == 0 && kRowPad % T::kKvBQ == 0 &&
         T::kDqBK % 16 == 0 && T::kKvBQ % 16 == 0 &&
         dq_smem<DQK, DV>() <= 232448 && dkdv_smem<DQK, DV>() <= 232448;
}

static_assert(tiles_ok<64, 64>() && tiles_ok<128, 128>() &&
                  tiles_ok<192, 128>(),
              "every row of a dq block and of a dkdv tile lies below S "
              "padded; k16 steps; at most 227 KB of shared memory a block");

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// (x, y) into entry i of kTerms bf16 A fragments: hi, and with two terms
// lo = bf16((x, y) - hi)
template <int kTerms, int N>
__device__ __forceinline__ void to_bf16(float x, float y,
                                        uint32_t (&f)[kTerms][N], int i) {
  if constexpr (kTerms == 2) split_bf16(x, y, f[0][i], f[1][i]);
  else f[0][i] = pack_bf16(x, y);
}

// k16 step kk of fragment term t: wgmma's four A registers
template <int kTerms, int N>
__device__ __forceinline__ void frag(const uint32_t (&f)[kTerms][N], int t,
                                     int kk, uint32_t (&a)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = f[t][4 * kk + j];
}

// One block: kDqBQ query rows of one (b, h), 64 a consumer warpgroup.
// Thread 0 issues every TMA load: Q and dO once, and each K / V tile
// kDqStages - 1 tiles ahead, into the slot of the tile both warpgroups have
// just finished.  Writes the rows' lse and Dl to `rows` ((B, H, 2, S padded
// to kRowPad) float32: lse, then Dl; 0 past S), then dQ.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                                  const __grid_constant__ CUtensorMap gmap,
                                  const __grid_constant__ CUtensorMap kmap,
                                  const __grid_constant__ CUtensorMap vmap,
                                  const __nv_bfloat16* __restrict__ o,
                                  const __nv_bfloat16* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  float* __restrict__ rows,
                                  __nv_bfloat16* __restrict__ dq, int S,
                                  int Tk, int H, int KV, float scale,
                                  int window) {
  constexpr int kDqBK = Tiles<DQK, DV>::kDqBK;
  constexpr int NQ = DQK / 64, NV = DV / 64;   // 64-wide d boxes
  constexpr uint32_t kQBox = box_bytes(kDqBQ), kKBox = box_bytes(kDqBK);
  constexpr uint32_t kQTile = NQ * kQBox, kKTile = NQ * kKBox;
  constexpr uint32_t kGTile = NV * kQBox, kVTile = NV * kKBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sG = sQ + kQTile;             // dO
  const uint32_t sK = sG + kGTile;
  const uint32_t sV = sK + kDqStages * kKTile;
  const uint32_t bars = sV + kDqStages * kVTile;
  const uint32_t q_bar = bars + 16 * kDqStages;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int n_qt = (S + kDqBQ - 1) / kDqBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * kDqBQ;
  // key tiles in which the mask leaves a pair: none past the block's last
  // row; with a window none wholly before k_min, the first key row q0 sees
  const int k_stop = min(Tk, min(S, q0 + kDqBQ));
  const int k_min = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_first = k_min / kDqBK * kDqBK;
  const int n_tiles =
      k_stop > k_min ? (k_stop - k_first + kDqBK - 1) / kDqBK : 0;

  // K and V tile i into stage i % kDqStages
  auto issue = [&](int i) {
    const int s = i % kDqStages;
    const uint32_t full = bars + 8 * s;
    const int k0 = k_first + i * kDqBK;
    mbar_expect_tx(full, kKTile + kVTile);
    for (int x = 0; x < NQ; ++x) {
      tma_load(sK + s * kKTile + x * kKBox, &kmap, full, 64 * x, kvh, k0, b);
      if (x < NV)
        tma_load(sV + s * kVTile + x * kKBox, &vmap, full, 64 * x, kvh, k0,
                 b);
    }
  };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(bars + 8 * s, 1);                               // full
      mbar_init(bars + 8 * (kDqStages + s), 128 * kConsumers);  // empty
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(q_bar, kQTile + kGTile);
    for (int x = 0; x < NQ; ++x) {
      tma_load(sQ + x * kQBox, &qmap, q_bar, 64 * x, h, q0, b);
      if (x < NV) tma_load(sG + x * kQBox, &gmap, q_bar, 64 * x, h, q0, b);
    }
    for (int i = 0; i < min(kDqStages, n_tiles); ++i) issue(i);
  }
  __syncthreads();

  const int lane = tid & 31;
  const int g = lane >> 2;                  // row in an 8-row group
  const int tq = lane & 3;                  // column pair in an 8-column group
  const int r_lo = q0 + 64 * wg;            // this warpgroup's rows
  const int row = r_lo + 16 * ((tid & 127) >> 5) + g;  // and row + 8
  const size_t q_row = static_cast<size_t>(H) * DQK;
  const size_t o_row = static_cast<size_t>(H) * DV;
  const size_t bh_s = static_cast<size_t>(bh) * S;
  const int s_pad = (S + kRowPad - 1) / kRowPad * kRowPad;
  float* rg = rows + static_cast<size_t>(bh) * 2 * s_pad;

  // Dl = rowsum(dO o) and lse of rows row and row + 8 (0 past S), read
  // while the first tiles land: each thread of a quad sums a quarter of
  // d in order, then the quad adds the four sums (the same bits in each).
  // Both go to the (b, h)'s rows of the scratch, which dkdv copies from
  float dl[2], ls[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = row + 8 * j;
    float a = 0.f;
    if (r < S) {
      const size_t at = (static_cast<size_t>(b) * S + r) * o_row +
                        static_cast<size_t>(h) * DV + tq * (DV / 4);
      const uint4* op = reinterpret_cast<const uint4*>(o + at);
      const uint4* gp = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
      for (int c = 0; c < DV / 32; ++c) {
        const uint4 ov = op[c], gv = gp[c];
        const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
        const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = unpack_bf16(ow[e]), gf = unpack_bf16(gw[e]);
          a = __fmaf_rn(gf.x, of.x, a);
          a = __fmaf_rn(gf.y, of.y, a);
        }
      }
    }
    a = quad_sum(a);
    dl[j] = a;
    ls[j] = r < S ? lse[bh_s + r] : 0.f;
    if (tq == 0) {                          // r < S padded: every row
      rg[r] = ls[j];
      rg[s_pad + r] = a;
    }
  }

  float acc[DQK / 2];                       // dQ: rows row, row + 8
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_bar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kDqStages;
    const int k0 = k_first + it * kDqBK;
    const uint32_t kt = sK + s * kKTile, vt = sV + s * kVTile;
    // the slot of tile it - 1 takes tile it - 1 + kDqStages once both
    // warpgroups are done with it
    if (tid == 0 && it > 0 && it - 1 + kDqStages < n_tiles) {
      const int j = it - 1;
      mbar_wait(bars + 8 * (kDqStages + j % kDqStages), (j / kDqStages) & 1);
      issue(j + kDqStages);
    }
    __syncwarp();
    mbar_wait(bars + 8 * s, (it / kDqStages) & 1);

    // S = Q K^T over DQK and dP = dO V^T over DV in steps of 16: a step
    // is 32 bytes into a box
    float sc[kDqBK / 2], dp[kDqBK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      const uint32_t qo = (kk / 4) * kQBox + (kk % 4) * 32 + wg * 64 * 128;
      const uint32_t ko = (kk / 4) * kKBox + (kk % 4) * 32;
      wgmma_ss<kDqBK>(sc, smem_desc(sQ + qo, 16, 1024),
                      smem_desc(kt + ko, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      const uint32_t qo = (kk / 4) * kQBox + (kk % 4) * 32 + wg * 64 * 128;
      const uint32_t ko = (kk / 4) * kKBox + (kk % 4) * 32;
      wgmma_ss<kDqBK>(dp, smem_desc(sG + qo, 16, 1024),
                      smem_desc(vt + ko, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dp);

    // P = exp(scale S - lse), 0 where masked (only where an edge cuts);
    // dS = P (dP - Dl) as kDsTerms bf16 A fragments
    const bool edge = k0 + kDqBK - 1 > r_lo || k0 + kDqBK > Tk ||
                      (window > 0 && k0 <= r_lo + 63 - window);
    uint32_t df[kDsTerms][kDqBK / 4];
#pragma unroll
    for (int i = 0; i < kDqBK / 8; ++i) {
      float d4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e >> 1;               // row + 8 j
        float p = exp2f(__fmul_rn(
            __fsub_rn(__fmul_rn(sc[4 * i + e], scale), ls[j]), kLog2e));
        if (edge) {
          const int r = row + 8 * j;
          const int c = k0 + 8 * i + 2 * tq + (e & 1);
          bool valid = c < Tk && c <= r;
          if (window > 0) valid = valid && c > r - window;
          if (!valid) p = 0.f;
        }
        d4[e] = __fmul_rn(p, __fsub_rn(dp[4 * i + e], dl[j]));
      }
      to_bf16<kDsTerms>(d4[0], d4[1], df, 2 * i);
      to_bf16<kDsTerms>(d4[2], d4[3], df, 2 * i + 1);
    }

    // dQ += dS K over the tile's keys in steps of 16 (16 rows of K, 2 KB),
    // each term of dS with the same K rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqBK / 16; ++kk) {
      const uint64_t kd = smem_desc(kt + kk * 2048, kKBox, 1024);
#pragma unroll
      for (int t = 0; t < kDsTerms; ++t) {
        uint32_t a[4];
        frag(df, t, kk, a);
        wgmma_rs<DQK>(acc, a, kd);
      }
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
#pragma unroll
    for (int t = 0; t < kDsTerms; ++t) fence_regs(df[t]);
    mbar_arrive(bars + 8 * (kDqStages + s));
  }

  // dQ = scale (dS K), rounded once
  __nv_bfloat16* qb = dq + (static_cast<size_t>(b) * S * H + h) * DQK + 2 * tq;
#pragma unroll
  for (int i = 0; i < DQK / 8; ++i) {
    if (row < S)
      *reinterpret_cast<uint32_t*>(qb + row * q_row + 8 * i) =
          pack_bf16(__fmul_rn(acc[4 * i], scale),
                    __fmul_rn(acc[4 * i + 1], scale));
    if (row + 8 < S)
      *reinterpret_cast<uint32_t*>(qb + (row + 8) * q_row + 8 * i) =
          pack_bf16(__fmul_rn(acc[4 * i + 2], scale),
                    __fmul_rn(acc[4 * i + 3], scale));
  }
}

// One block: kKvBK keys of one (b, kv head), 64 a consumer warpgroup.
// Walks the kv head's H / KV query heads in order and, for each, the query
// tiles its mask leaves, accumulating dK and dV.  There is no producer
// warp: thread 0 issues every copy, K and V once, and each Q / dO tile
// with its rows of lse and Dl (bulk copies from the dq kernel's scratch)
// kKvStages - 1 tiles ahead, into the slot of the tile both warpgroups
// have just finished.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                                    const __grid_constant__ CUtensorMap gmap,
                                    const __grid_constant__ CUtensorMap kmap,
                                    const __grid_constant__ CUtensorMap vmap,
                                    const float* __restrict__ rows,
                                    __nv_bfloat16* __restrict__ dk,
                                    __nv_bfloat16* __restrict__ dv, int S,
                                    int Tk, int H, int KV, float scale,
                                    int window) {
  constexpr int kKvBQ = Tiles<DQK, DV>::kKvBQ;
  constexpr int NQ = DQK / 64, NV = DV / 64;   // 64-wide d boxes
  constexpr uint32_t kKBox = box_bytes(kKvBK), kQBox = box_bytes(kKvBQ);
  constexpr uint32_t kKTile = NQ * kKBox, kQTile = NQ * kQBox;
  constexpr uint32_t kVTile = NV * kKBox, kGTile = NV * kQBox;
  constexpr uint32_t kRowBytes = kKvBQ * 4;   // a tile's lse (or Dl)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_addr(smem_raw);
  const uint32_t sK = (base + 1023) & ~1023u;
  const uint32_t sV = sK + kKTile;
  const uint32_t sQ = sV + kVTile;
  const uint32_t sG = sQ + kKvStages * kQTile;            // dO
  const uint32_t sRows = sG + kKvStages * kGTile;         // lse, Dl a stage
  const uint32_t bars = sRows + kKvStages * 2 * kRowBytes;
  const uint32_t kv_bar = bars + 16 * kKvStages;
  const float* srows = reinterpret_cast<const float*>(smem_raw + (sRows - base));

  const int bkv = blockIdx.x;
  const int b = bkv / KV;
  const int kvh = bkv - b * KV;
  const int G = H / KV;
  const int k0 = static_cast<int>(blockIdx.y) * kKvBK;   // heaviest first
  const int s_pad = (S + kRowPad - 1) / kRowPad * kRowPad;
  // query tiles in which the mask leaves a pair: from the tile of row k0;
  // with a window, none at or past the last key + window
  const int q_begin = k0 / kKvBQ * kKvBQ;
  const int q_end = window > 0 ? min(S, min(Tk, k0 + kKvBK) - 1 + window) : S;
  const int n_q = q_end > q_begin ? (q_end - q_begin + kKvBQ - 1) / kKvBQ : 0;
  const int n_iters = G * n_q;

  // tile i of the walk (query head kvh G + i / n_q) into stage i % kKvStages
  auto issue = [&](int i) {
    const int s = i % kKvStages;
    const int g = i / n_q;
    const int q0 = q_begin + (i - g * n_q) * kKvBQ;
    const int h = kvh * G + g;
    const uint32_t full = bars + 8 * s;
    mbar_expect_tx(full, kQTile + kGTile + 2 * kRowBytes);
    for (int x = 0; x < NQ; ++x) {
      tma_load(sQ + s * kQTile + x * kQBox, &qmap, full, 64 * x, h, q0, b);
      if (x < NV)
        tma_load(sG + s * kGTile + x * kQBox, &gmap, full, 64 * x, h, q0, b);
    }
    const float* src = rows + (static_cast<size_t>(b) * H + h) * 2 * s_pad + q0;
    bulk_load(sRows + s * 2 * kRowBytes, src, kRowBytes, full);
    bulk_load(sRows + s * 2 * kRowBytes + kRowBytes, src + s_pad, kRowBytes,
              full);
  };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(bars + 8 * s, 1);                               // full
      mbar_init(bars + 8 * (kKvStages + s), 128 * kConsumers);  // empty
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(kv_bar, kKTile + kVTile);
    for (int x = 0; x < NQ; ++x) {
      tma_load(sK + x * kKBox, &kmap, kv_bar, 64 * x, kvh, k0, b);
      if (x < NV) tma_load(sV + x * kKBox, &vmap, kv_bar, 64 * x, kvh, k0, b);
    }
    for (int i = 0; i < min(kKvStages, n_iters); ++i) issue(i);
  }
  __syncthreads();

  const int lane = tid & 31;
  const int gr = lane >> 2;                   // row in an 8-row group
  const int tq = lane & 3;                    // column pair in an 8-column group
  const int k_lo = k0 + 64 * wg;              // this warpgroup's keys
  const int key = k_lo + 16 * ((tid & 127) >> 5) + gr;  // and key + 8
  float ak[DQK / 2], av[DV / 2];              // dK, dV: keys key, key + 8
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) {
    ak[i] = 0.f;
    if (i < DV / 2) av[i] = 0.f;
  }
  mbar_wait(kv_bar, 0);

  for (int it = 0; it < n_iters; ++it) {
    const int s = it % kKvStages;
    const int g = it / n_q;
    const int q0 = q_begin + (it - g * n_q) * kKvBQ;
    const uint32_t qt = sQ + s * kQTile, gt = sG + s * kGTile;
    // the slot of tile it - 1 takes tile it - 1 + kKvStages once both
    // warpgroups are done with it
    if (tid == 0 && it > 0 && it - 1 + kKvStages < n_iters) {
      const int j = it - 1;
      mbar_wait(bars + 8 * (kKvStages + j % kKvStages), (j / kKvStages) & 1);
      issue(j + kKvStages);
    }
    __syncwarp();
    mbar_wait(bars + 8 * s, (it / kKvStages) & 1);

    // S^T = K Q^T over DQK and dP^T = V dO^T over DV in steps of 16
    float sc[kKvBQ / 2], dp[kKvBQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      const uint32_t ko = (kk / 4) * kKBox + (kk % 4) * 32 + wg * 64 * 128;
      const uint32_t qo = (kk / 4) * kQBox + (kk % 4) * 32;
      wgmma_ss<kKvBQ>(sc, smem_desc(sK + ko, 16, 1024),
                      smem_desc(qt + qo, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      const uint32_t ko = (kk / 4) * kKBox + (kk % 4) * 32 + wg * 64 * 128;
      const uint32_t qo = (kk / 4) * kQBox + (kk % 4) * 32;
      wgmma_ss<kKvBQ>(dp, smem_desc(sV + ko, 16, 1024),
                      smem_desc(gt + qo, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dp);

    // P^T = exp(scale S^T - lse), 0 where masked (only where an edge
    // cuts), dS^T = P^T (dP^T - Dl): the column's lse and Dl from the
    // stage; both as bf16 A fragments
    const float* rs = srows + s * 2 * kKvBQ;
    const bool edge = q0 < k_lo + 63 || k_lo + 64 > Tk || q0 + kKvBQ > S ||
                      (window > 0 && q0 + kKvBQ - 1 - k_lo >= window);
    uint32_t pf[kPTerms][kKvBQ / 4], df[kDsTerms][kKvBQ / 4];
#pragma unroll
    for (int i = 0; i < kKvBQ / 8; ++i) {
      const int c = 8 * i + 2 * tq;         // the tile's query c, c + 1
      const float2 l2 = *reinterpret_cast<const float2*>(rs + c);
      const float2 d2 = *reinterpret_cast<const float2*>(rs + kKvBQ + c);
      float p4[4], d4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = (e & 1) ? l2.y : l2.x;
        const float dl = (e & 1) ? d2.y : d2.x;
        float p = exp2f(__fmul_rn(
            __fsub_rn(__fmul_rn(sc[4 * i + e], scale), l), kLog2e));
        if (edge) {
          const int qr = q0 + c + (e & 1);
          const int kc = key + ((e & 2) ? 8 : 0);
          bool valid = kc < Tk && kc <= qr && qr < S;
          if (window > 0) valid = valid && kc > qr - window;
          if (!valid) p = 0.f;
        }
        p4[e] = p;
        d4[e] = __fmul_rn(p, __fsub_rn(dp[4 * i + e], dl));
      }
      to_bf16<kPTerms>(p4[0], p4[1], pf, 2 * i);
      to_bf16<kPTerms>(p4[2], p4[3], pf, 2 * i + 1);
      to_bf16<kDsTerms>(d4[0], d4[1], df, 2 * i);
      to_bf16<kDsTerms>(d4[2], d4[3], df, 2 * i + 1);
    }

    // dV += P^T dO and dK += dS^T Q over the tile's queries in steps of
    // 16 (16 rows of dO / Q, 2 KB), each term with the same rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKvBQ / 16; ++kk) {
      const uint64_t gd = smem_desc(gt + kk * 2048, kQBox, 1024);
      const uint64_t qd = smem_desc(qt + kk * 2048, kQBox, 1024);
#pragma unroll
      for (int t = 0; t < kPTerms; ++t) {
        uint32_t a[4];
        frag(pf, t, kk, a);
        wgmma_rs<DV>(av, a, gd);
      }
#pragma unroll
      for (int t = 0; t < kDsTerms; ++t) {
        uint32_t a[4];
        frag(df, t, kk, a);
        wgmma_rs<DQK>(ak, a, qd);
      }
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(av);
    fence_regs(ak);
#pragma unroll
    for (int t = 0; t < kPTerms; ++t) fence_regs(pf[t]);
#pragma unroll
    for (int t = 0; t < kDsTerms; ++t) fence_regs(df[t]);
    mbar_arrive(bars + 8 * (kKvStages + s));
  }

  // dK = scale (dS^T Q) and dV, rounded once
  const size_t k_row = static_cast<size_t>(KV) * DQK;
  const size_t v_row = static_cast<size_t>(KV) * DV;
  const size_t at_k = (static_cast<size_t>(b) * Tk * KV + kvh) * DQK + 2 * tq;
  const size_t at_v = (static_cast<size_t>(b) * Tk * KV + kvh) * DV + 2 * tq;
#pragma unroll
  for (int i = 0; i < DQK / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kr = key + 8 * j;
      if (kr >= Tk) continue;
      *reinterpret_cast<uint32_t*>(dk + at_k + kr * k_row + 8 * i) =
          pack_bf16(__fmul_rn(ak[4 * i + 2 * j], scale),
                    __fmul_rn(ak[4 * i + 2 * j + 1], scale));
      if (i < DV / 8)
        *reinterpret_cast<uint32_t*>(dv + at_v + kr * v_row + 8 * i) =
            pack_bf16(av[4 * i + 2 * j], av[4 * i + 2 * j + 1]);
    }
  }
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int S, int Tk, int H, int KV,
           float scale, int window, cudaStream_t stream) {
  constexpr int kDqBK = Tiles<DQK, DV>::kDqBK;
  constexpr int kKvBQ = Tiles<DQK, DV>::kKvBQ;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // each kernel's maps, in its tiles' box heights
  CUtensorMap q_dq, g_dq, k_dq, v_dq, q_kv, g_kv, k_kv, v_kv;
  if (!make_map(&q_dq, encode, q, B, S, H, DQK, kDqBQ) ||
      !make_map(&g_dq, encode, dout, B, S, H, DV, kDqBQ) ||
      !make_map(&k_dq, encode, k, B, Tk, KV, DQK, kDqBK) ||
      !make_map(&v_dq, encode, v, B, Tk, KV, DV, kDqBK) ||
      !make_map(&q_kv, encode, q, B, S, H, DQK, kKvBQ) ||
      !make_map(&g_kv, encode, dout, B, S, H, DV, kKvBQ) ||
      !make_map(&k_kv, encode, k, B, Tk, KV, DQK, kKvBK) ||
      !make_map(&v_kv, encode, v, B, Tk, KV, DV, kKvBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (S + kDqBQ - 1) / kDqBQ;
  const int n_kt = (Tk + kKvBK - 1) / kKvBK;
  if (n_qt > 65535 || n_kt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto dq_kernel = flash_attention_bwd_dq_kernel<DQK, DV>;
  auto dkdv_kernel = flash_attention_bwd_dkdv_kernel<DQK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem<DQK, DV>()));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dkdv_smem<DQK, DV>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* o_t = static_cast<const __nv_bfloat16*>(o);
  const auto* g_t = static_cast<const __nv_bfloat16*>(dout);
  dq_kernel<<<dim3(B * H, n_qt), kThreads, dq_smem<DQK, DV>(), stream>>>(
      q_dq, g_dq, k_dq, v_dq, o_t, g_t, lse, delta,
      static_cast<__nv_bfloat16*>(dq), S, Tk, H, KV, scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<<<dim3(B * KV, n_kt), kThreads, dkdv_smem<DQK, DV>(),
                stream>>>(q_kv, g_kv, k_kv, v_kv, delta,
                          static_cast<__nv_bfloat16*>(dk),
                          static_cast<__nv_bfloat16*>(dv), S, Tk, H, KV,
                          scale, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tensor_core

// The floats of the `delta` scratch that repro_flash_attention_bwd needs
// for (B, H, S): B H 5 S', S' = S rounded up to a multiple of kRowPad.
// The bf16 kernels keep lse and Dl there as (B, H, 2, S'), the float32
// ones lse, Dl and each row's slot as (B, H, 5, S').
static_assert(tf32x3::kPad == tensor_core::kRowPad && tf32x3::kRowPlanes >= 2,
              "the float32 layout holds the bf16 one");
extern "C" long long repro_flash_attention_bwd_scratch(int B, int H, int S) {
  const long long pad = tensor_core::kRowPad;
  return static_cast<long long>(B) * H * tf32x3::kRowPlanes *
         ((S + pad - 1) / pad * pad);
}

// dtype: 0 float32, 1 bfloat16.  window <= 0: no window.  (D, DV), the
// widths of q / k and of v / o / dout: (64, 64), (128, 128) or MLA's
// (192, 128), each kernel at its pair's tiles (`Tiles`).  delta: float32
// scratch of repro_flash_attention_bwd_scratch(B, H, S) floats.  Launches
// the dq kernel, then the dkdv kernel, on `stream`.  Returns
// cudaErrorInvalidValue for any other dtype or pair.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int S, int Tk, int H, int KV, int D, int DV,
    float scale, int window, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || Tk <= 0) return 0;
  if (H <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 128 && DV == 128)
    return tf32x3::launch<128, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    B, S, Tk, H, KV, scale, window, stream);
  if (dtype == 0 && D == 64 && DV == 64)
    return tf32x3::launch<64, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  B, S, Tk, H, KV, scale, window, stream);
  if (dtype == 0 && D == 192 && DV == 128)
    return tf32x3::launch<192, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    B, S, Tk, H, KV, scale, window, stream);
  if (dtype == 1 && D == 128 && DV == 128)
    return tensor_core::launch<128, 128>(q, k, v, o, dout, lse, delta, dq, dk,
                                         dv, B, S, Tk, H, KV, scale, window,
                                         stream);
  if (dtype == 1 && D == 64 && DV == 64)
    return tensor_core::launch<64, 64>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, B, S, Tk, H, KV, scale, window,
                                       stream);
  if (dtype == 1 && D == 192 && DV == 128)
    return tensor_core::launch<192, 128>(q, k, v, o, dout, lse, delta, dq, dk,
                                         dv, B, S, Tk, H, KV, scale, window,
                                         stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
