// Tensor-core building blocks shared by the bf16 flash-attention kernels:
// the forward K1 (flash_fwd.cu) and the backward K2 (flash_bwd.cu), sm_90a.
//
// Every product is `mma.sync.m16n8k16` with bf16 operands and fp32
// accumulators. A warp owns 16 rows of its CTA's 64-row tile. Tiles of 64
// (K1's K/V: 32 or 64) rows of a packed [B, L, H*d] tensor are staged in
// shared memory and read into fragments by `ldmatrix`, transposed where the
// product needs the tile's columns as its reduction. An accumulator
// fragment of one product is, register for register, the A fragment of the
// next (PTX ISA, "Matrix Fragments for mma.m16n8k16"), so the probabilities
// P and dS go from one product into the next without a trip through shared
// memory.
//
// Head dims. A kernel is instantiated on a WIDTH DP, a multiple of 8 (32,
// 40, 48, 64, 96, 128, 256: kernel_width() below), and takes the
// real head dim d <= DP at run time, as the JAX kernel takes `d_real`: every
// row offset, pitch and store uses d, and the columns d..DP-1 of a staged
// tile are zero in shared memory (zero_pad_columns), so the products over
// them add nothing. Nothing is padded in device memory.
//
// Staging. Where d is a multiple of 8 (the wrapper then holds every
// pointer and stride to 16-byte alignment), rows go through `cp.async` in
// 16-byte chunks, zero-filled past the sequence's end, so the copy of the next tile
// overlaps the products on this one. Otherwise (a d that is not a multiple
// of 8: the thirds of a fused projection then sit at offsets h*d*2 bytes)
// every element is loaded and stored on its own, synchronously.
//
// Layout of a staged tile: rows of kPad bf16 (DP rounded up to the k16 of
// the mma) plus 8 bf16 of padding: the row pitch is then an odd multiple
// of 16 bytes, so the 8 rows that one `ldmatrix` 8x8 matrix reads start in
// 8 distinct groups of 4 banks, and it reads without bank conflicts. Tiles
// live in dynamic shared memory (above 48 KB from DP = 96 on).
//
// Wide heads (d > kMaxHeadDim): no width is built for them. Their kernels
// (flash_fwd.cu, flash_bwd.cu: the *_wide_* kernels) cut d into chunks of
// kWideCols columns, staged one at a time as tiles of width kWideCols
// (load_chunk), and a CTA owns one such column block of its output: S and
// dP sum over every chunk of d, the outputs O, dV, dK and dQ split by
// column, so nothing wider than one chunk is ever held.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_mma {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // 128
constexpr int kTile = 64;              // rows of a staged tile, 16 per warp
constexpr int kMaxHeadDim = 256;
constexpr int kWideCols = 64;  // the chunk of d, and column block, of a wide head
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

template <int DP>
struct Dims {
  static_assert(DP % 8 == 0 && DP <= kMaxHeadDim, "a width of whole n8 tiles");
  static constexpr int kPad = (DP + 15) / 16 * 16;  // reduction width over d
  static constexpr int kStride = kPad + 8;          // smem row pitch, elements
  static constexpr int kK16 = kPad / 16;            // k16 steps over d
  static constexpr int kN8 = DP / 8;                // n8 output tiles over d
  static constexpr int kTileElems = kTile * kStride;
};

// The width a head dim d (1..256) runs at: the least that holds it; 0 for
// a d that no width takes (above 256 the wide kernels run it). The wrapper
// (ops/flash_attention.py, KERNEL_WIDTHS) holds the same table.
__host__ __device__ constexpr int kernel_width(int d) {
  return d < 1 ? 0 : d <= 32 ? 32 : d <= 40 ? 40 : d <= 48 ? 48 : d <= 64 ? 64
       : d <= 96 ? 96 : d <= 128 ? 128 : d <= kMaxHeadDim ? kMaxHeadDim : 0;
}

// The launch's grid, one CTA per (row tile, head, batch row) in x: blockIdx.x
// = (b * H + h) * tiles + tile, so a batch of any size fits (x takes 2^31 - 1
// blocks; y and z 65535).
struct GridIdx {
  int tile, h;
  int64_t b;
};

__device__ __forceinline__ GridIdx grid_idx(int tiles, int H) {
  const unsigned x = blockIdx.x;  // 32-bit divisions: grid.x < 2^31
  const unsigned bh = x / static_cast<unsigned>(tiles);
  return {static_cast<int>(x - bh * tiles), static_cast<int>(bh % static_cast<unsigned>(H)),
          static_cast<int64_t>(bh / static_cast<unsigned>(H))};
}

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

// Zero the columns d..kPad-1 of `rows` staged rows. The loads never write
// them, so once per kernel is enough; nothing to do where d = kPad.
template <int DP>
__device__ __forceinline__ void zero_pad_columns(bf16* smem, int rows, int d) {
  using P = Dims<DP>;
  const int w = P::kPad - d;
  if (w <= 0) return;
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < rows * w; e += kThreads) {
    const int r = e / w;
    smem[r * P::kStride + d + (e - r * w)] = zero;
  }
}

// The cp.async copies of kRows rows of `chunks` 16-byte chunks: rows
// 0..valid-1 from `src` (row pitch `ld` elements, 16-byte aligned), the rest
// zero-filled.
template <int DP, int kRows>
__device__ __forceinline__ void load_chunks(bf16* dst, const bf16* src, int64_t ld,
                                            int valid, int chunks) {
  const uint32_t base = smem_addr(dst);
  for (int e = threadIdx.x; e < kRows * chunks; e += kThreads) {
    const int r = e / chunks;
    const int c = e - r * chunks;
    const bool ok = r < valid;
    const bf16* g = src + (ok ? r : 0) * ld + c * 8;  // row 0 exists when !ok
    cp_async16(base + (r * Dims<DP>::kStride + c * 8) * 2, g, ok);
  }
}

// Issue the copies of a tile of kRows rows of d columns: rows 0..valid-1
// from `src` (row pitch `ld` elements), the rest zero. Where d is a
// multiple of 8: 16-byte cp.async chunks (src and ld 16-byte aligned), to
// be committed and awaited by the caller; else element by element, done on
// return.
template <int DP, int kRows = kTile>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t ld, int valid,
                                          int d) {
  using P = Dims<DP>;
  if ((d & 7) == 0) {
    if (d == DP)  // the width's own chunk count: a constant divisor
      load_chunks<DP, kRows>(dst, src, ld, valid, DP / 8);
    else
      load_chunks<DP, kRows>(dst, src, ld, valid, d >> 3);
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = threadIdx.x; e < kRows * d; e += kThreads) {
      const int r = e / d;
      const int c = e - r * d;
      dst[r * P::kStride + c] = r < valid ? src[r * ld + c] : zero;
    }
  }
}

// Issue the copies of one chunk of a wide head into a tile of kRows rows
// of width DP: columns 0..cols-1 of rows 0..valid-1 from `src` (row pitch
// `ld` elements), every other element of the tile zero (the columns past d
// in the last chunk, the rows past the sequence's end), so that a slot can
// hold any chunk in turn. Where `vec` (d a multiple of 8: src and ld
// 16-byte aligned, cols a multiple of 8): 16-byte cp.async chunks,
// zero-filled, to be committed and awaited by the caller; else element by
// element, done on return.
template <int DP, int kRows>
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src, int64_t ld, int valid,
                                           int cols, bool vec) {
  using P = Dims<DP>;
  if (vec) {
    constexpr int kChunks = DP / 8;
    const uint32_t base = smem_addr(dst);
    for (int e = threadIdx.x; e < kRows * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int c = e - r * kChunks;
      const bool ok = r < valid && c * 8 < cols;
      cp_async16(base + (r * P::kStride + c * 8) * 2, ok ? src + r * ld + c * 8 : src, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = threadIdx.x; e < kRows * DP; e += kThreads) {
      const int r = e / DP;
      const int c = e - r * DP;
      dst[r * P::kStride + c] = r < valid && c < cols ? src[r * ld + c] : zero;
    }
  }
}

// The shared address of this lane's row of the A fragments of 16 staged
// rows from `row0`; the k16 step kt is 32 bytes on.
template <int DP>
__device__ __forceinline__ uint32_t a_base(const bf16* tile, int row0) {
  const int lane = threadIdx.x & 31;
  return smem_addr(tile) + ((row0 + (lane & 15)) * Dims<DP>::kStride + (lane >> 4) * 8) * 2;
}

// The shared address of this lane's row of the B fragments for the keys (or
// queries) n0..n0+15 of a staged tile whose rows are the n dimension and
// whose columns the reduction (b[0..1] for n0..n0+7, b[2..3] for
// n0+8..n0+15); the k16 step kt is 32 bytes on.
template <int DP>
__device__ __forceinline__ uint32_t bt_base(const bf16* tile, int n0) {
  const int lane = threadIdx.x & 31;
  return smem_addr(tile) +
         ((n0 + (lane & 7) + ((lane >> 4) << 3)) * Dims<DP>::kStride + ((lane >> 3) & 1) * 8) *
             2;
}

// The A fragments (16 rows from `row0`, all of kPad) of a staged tile.
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&a)[Dims<DP>::kK16][4], const bf16* tile,
                                       int row0) {
  const uint32_t base = a_base<DP>(tile, row0);
#pragma unroll
  for (int kt = 0; kt < Dims<DP>::kK16; ++kt) ldsm_x4(a[kt], base + kt * 32);
}

// c0/c1 (+)= A B^T for the 16x16 block of keys (or queries) n0..n0+15 of a
// staged tile whose rows are the n dimension and whose columns the
// reduction over d: S = Q K^T, dP = dO V^T, and their transposes. A from
// registers.
template <int DP>
__device__ __forceinline__ void mma_abt(float (&c0)[4], float (&c1)[4],
                                        const uint32_t (&a)[Dims<DP>::kK16][4],
                                        const bf16* tile, int n0) {
  const uint32_t base = bt_base<DP>(tile, n0);
#pragma unroll
  for (int kt = 0; kt < Dims<DP>::kK16; ++kt) {
    uint32_t b[4];
    ldsm_x4(b, base + kt * 32);
    mma16816(c0, a[kt], b[0], b[1]);
    mma16816(c1, a[kt], b[2], b[3]);
  }
}

// The same with A read from the staged tile `atile` (16 rows from `arow0`)
// one k16 step at a time: the wide heads, whose fragments over d would
// not fit in registers beside the accumulators.
template <int DP>
__device__ __forceinline__ void mma_abt_s(float (&c0)[4], float (&c1)[4], const bf16* atile,
                                          int arow0, const bf16* tile, int n0) {
  const uint32_t abase = a_base<DP>(atile, arow0), bbase = bt_base<DP>(tile, n0);
#pragma unroll
  for (int kt = 0; kt < Dims<DP>::kK16; ++kt) {
    uint32_t a[4], b[4];
    ldsm_x4(a, abase + kt * 32);
    ldsm_x4(b, bbase + kt * 32);
    mma16816(c0, a, b[0], b[1]);
    mma16816(c1, a, b[2], b[3]);
  }
}

// acc (+)= A T for a 16-row A block whose columns are the staged tile's rows
// k0..k0+15, over kN n8 tiles of the tile's columns from c0 (the output's
// d): O += P V, dV += P^T dO, dK += dS^T Q, dQ += dS K. The tile's columns
// are the n dimension, so ldmatrix transposes.
template <int DP, int kN>
__device__ __forceinline__ void mma_at(float (&acc)[kN][4], const uint32_t (&a)[4],
                                       const bf16* tile, int k0, int c0 = 0) {
  using P = Dims<DP>;
  const int lane = threadIdx.x & 31;
  const uint32_t base =
      smem_addr(tile) +
      ((k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P::kStride + c0 + (lane >> 4) * 8) * 2;
#pragma unroll
  for (int nt = 0; nt + 1 < kN; nt += 2) {
    uint32_t b[4];
    ldsm_x4_t(b, base + nt * 16);
    mma16816(acc[nt], a, b[0], b[1]);
    mma16816(acc[nt + 1], a, b[2], b[3]);
  }
  if constexpr (kN % 2) {  // DP = 40: the fifth n8 tile alone
    uint32_t b[2];
    ldsm_x2_t(b, base + (kN - 1) * 16);
    mma16816(acc[kN - 1], a, b[0], b[1]);
  }
}

// Store a warp's 16 output rows (from `row0`; rows >= `rows` are skipped)
// of an fp32 accumulator over kN n8 tiles of columns from c0 (columns >= d
// are skipped), times `mul_lo` (row g) and `mul_hi` (row g+8), as bf16 into
// a row-major [*, ld] array: two columns in one 4-byte store where d is
// even, one at a time where it is odd.
template <int kN>
__device__ __forceinline__ void store_rows(bf16* dst, int64_t ld, int row0, int rows,
                                           const float (&acc)[kN][4], float mul_lo,
                                           float mul_hi, int d, int c0 = 0) {
  const int lane = threadIdx.x & 31;
  const int r = row0 + (lane >> 2);
  const int c = c0 + 2 * (lane & 3);
  const bool pairs = (d & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < kN; ++nt) {
    const int col = c + nt * 8;
    if (col >= d) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r + 8 * half;
      if (row >= rows) continue;
      const float mul = half ? mul_hi : mul_lo;
      const float x0 = acc[nt][2 * half] * mul, x1 = acc[nt][2 * half + 1] * mul;
      bf16* p = dst + row * ld + col;
      if (pairs) {
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(x0, x1);
      } else {
        p[0] = __float2bfloat16(x0);
        if (col + 1 < d) p[1] = __float2bfloat16(x1);
      }
    }
  }
}

// Raise the dynamic shared memory a kernel may take above the 48 KB
// default; the launch is refused where the card has less.
template <typename Kernel>
__host__ inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace flash_mma
