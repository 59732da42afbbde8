// Tensor-core building blocks shared by the bf16 flash-attention kernels:
// the forward K1 (flash_fwd.cu) and the backward K2 (flash_bwd.cu), sm_90a.
//
// Every product is `mma.sync.m16n8k16` with bf16 operands and fp32
// accumulators. A warp owns 16 rows of its CTA's 64-row tile. Tiles of 64
// (K1's K/V: 32 or 64) rows of a packed [B, L, H*d] tensor are staged in
// shared memory by
// `cp.async` (16-byte chunks, zero-filled past the sequence's end, so
// nothing is padded in device memory) and read into fragments by
// `ldmatrix`, transposed where the product needs the tile's columns as its
// reduction. An accumulator fragment of one product is, register for
// register, the A fragment of the next (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), so the probabilities P and dS go from one product into the
// next without a trip through shared memory.
//
// Layout of a staged tile: rows of kPad bf16 (d rounded up to the k16 of
// the mma; the columns past d are zero, so the reduction over d = 40 runs as
// 48) plus 8 bf16 of padding: the row pitch is then 80, 112 or 144 bytes,
// and the 8 rows that one `ldmatrix` 8x8 matrix reads start in 8 distinct
// groups of 4 banks, so it reads without bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash_mma {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // 128
constexpr int kTile = 64;              // rows of a staged tile, 16 per warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

template <int D>
struct Dims {
  static constexpr int kPad = (D + 15) / 16 * 16;  // reduction width over d
  static constexpr int kStride = kPad + 8;         // smem row pitch, elements
  static constexpr int kChunks = D / 8;            // 16-byte chunks of a row
  static constexpr int kK16 = kPad / 16;           // k16 steps over d
  static constexpr int kN8 = D / 8;                // n8 output tiles over d
  static constexpr int kTileElems = kTile * kStride;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(n));
}

// 4 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c[16x8] += a[16x16] b[16x8], bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 -> one register of two bf16, `lo` in the low half (the lower
// column of a fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the MUFU (ex2.approx: 2 ulp; ex2(-inf) = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The A fragment of the 16x16 block at columns 16j.. of rows `s`' 16 rows
// (row g in c[0..1], row g+8 in c[2..3] of each n8 accumulator), rounded to
// bf16: the accumulators of n8 tiles 2j and 2j+1.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Zero the columns d..kPad-1 of `rows` staged rows (d = 40 only); cp.async
// never writes them, so once per kernel is enough.
template <int D>
__device__ __forceinline__ void zero_pad_columns(bf16* smem, int rows) {
  using P = Dims<D>;
  if constexpr (P::kPad != D) {
    static_assert(P::kPad - D == 8, "one 16-byte chunk of padding");
    for (int r = threadIdx.x; r < rows; r += kThreads)
      *reinterpret_cast<uint4*>(smem + r * P::kStride + D) = make_uint4(0, 0, 0, 0);
  }
}

// Issue the cp.async copies of a tile of kRows rows: rows 0..valid-1 from
// `src` (row pitch `ld` elements, 16-byte aligned), the rest zero-filled.
template <int D, int kRows = kTile>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t ld, int valid) {
  using P = Dims<D>;
  const uint32_t base = smem_addr(dst);
  for (int e = threadIdx.x; e < kRows * P::kChunks; e += kThreads) {
    const int r = e / P::kChunks;
    const int c = e - r * P::kChunks;
    const bool ok = r < valid;
    const bf16* g = src + (ok ? r : 0) * ld + c * 8;  // row 0 exists when !ok
    cp_async16(base + (r * P::kStride + c * 8) * 2, g, ok);
  }
}

// The A fragments (16 rows from `row0`, all of kPad) of a staged tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[Dims<D>::kK16][4], const bf16* tile,
                                       int row0) {
  using P = Dims<D>;
  const int lane = threadIdx.x & 31;
  const uint32_t base =
      smem_addr(tile) + ((row0 + (lane & 15)) * P::kStride + (lane >> 4) * 8) * 2;
#pragma unroll
  for (int kt = 0; kt < P::kK16; ++kt) ldsm_x4(a[kt], base + kt * 32);
}

// c0/c1 (+)= A B^T for the 16x16 block of keys (or queries) n0..n0+15 of a
// staged tile whose rows are the n dimension and whose columns the
// reduction over d: S = Q K^T, dP = dO V^T, and their transposes.
template <int D>
__device__ __forceinline__ void mma_abt(float (&c0)[4], float (&c1)[4],
                                        const uint32_t (&a)[Dims<D>::kK16][4],
                                        const bf16* tile, int n0) {
  using P = Dims<D>;
  const int lane = threadIdx.x & 31;
  const uint32_t base =
      smem_addr(tile) +
      ((n0 + (lane & 7) + ((lane >> 4) << 3)) * P::kStride + ((lane >> 3) & 1) * 8) * 2;
#pragma unroll
  for (int kt = 0; kt < P::kK16; ++kt) {
    uint32_t b[4];
    ldsm_x4(b, base + kt * 32);
    mma16816(c0, a[kt], b[0], b[1]);
    mma16816(c1, a[kt], b[2], b[3]);
  }
}

// acc (+)= A T for a 16-row A block whose columns are the staged tile's rows
// k0..k0+15, over every column of the tile (the output's d): O += P V,
// dV += P^T dO, dK += dS^T Q, dQ += dS K. The tile's columns are the n
// dimension, so ldmatrix transposes.
template <int D>
__device__ __forceinline__ void mma_at(float (&acc)[Dims<D>::kN8][4], const uint32_t (&a)[4],
                                       const bf16* tile, int k0) {
  using P = Dims<D>;
  const int lane = threadIdx.x & 31;
  const uint32_t base =
      smem_addr(tile) +
      ((k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P::kStride + (lane >> 4) * 8) * 2;
#pragma unroll
  for (int nt = 0; nt + 1 < P::kN8; nt += 2) {
    uint32_t b[4];
    ldsm_x4_t(b, base + nt * 16);
    mma16816(acc[nt], a, b[0], b[1]);
    mma16816(acc[nt + 1], a, b[2], b[3]);
  }
  if constexpr (P::kN8 % 2) {  // d = 40: the fifth n8 tile alone
    uint32_t b[2];
    ldsm_x2_t(b, base + (P::kN8 - 1) * 16);
    mma16816(acc[P::kN8 - 1], a, b[0], b[1]);
  }
}

// Store a warp's 16 output rows (from `row0`; rows >= `rows` are skipped)
// of an fp32 accumulator over d, times `mul_lo` (row g) and `mul_hi` (row
// g+8), as bf16 into a row-major [*, ld] array.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, int64_t ld, int row0, int rows,
                                           const float (&acc)[Dims<D>::kN8][4], float mul_lo,
                                           float mul_hi) {
  const int lane = threadIdx.x & 31;
  const int r = row0 + (lane >> 2);
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < Dims<D>::kN8; ++nt) {
    if (r < rows)
      *reinterpret_cast<uint32_t*>(dst + r * ld + nt * 8 + c) =
          pack_bf16(acc[nt][0] * mul_lo, acc[nt][1] * mul_lo);
    if (r + 8 < rows)
      *reinterpret_cast<uint32_t*>(dst + (r + 8) * ld + nt * 8 + c) =
          pack_bf16(acc[nt][2] * mul_hi, acc[nt][3] * mul_hi);
  }
}

}  // namespace flash_mma
