// Tensor-core building blocks shared by the bf16 flash-attention kernels:
// the forward K1 (flash_fwd.cu) and the backward K2 (flash_bwd.cu), sm_90a.
//
// Every product is `mma.sync.m16n8k16` with bf16 operands and fp32
// accumulators (K1's wide kernel: `wgmma`, section "Wide heads", whose
// accumulators and register A operand have the same layout in each warp).
// A warp owns 16 rows of its CTA's 64-row tile. Tiles of 64
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
// kWideCols = 64 columns and the output's columns into groups of up to
// kGroupChunks chunks (512 columns), one CTA per (row tile, group): S and dP
// are summed over every chunk of d once per tile pair and group, and the
// CTA's warps split the group's columns (the section "Wide heads" below).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if CUDART_VERSION < 12050
#error "the flash kernels need CUDA 12.5 or later (cudaGetDriverEntryPointByVersion)"
#endif

namespace flash_mma {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // 128
constexpr int kTile = 64;              // rows of a staged tile, 16 per warp
constexpr int kMaxHeadDim = 256;
constexpr int kWideCols = 64;     // the chunk of d of a wide head
constexpr int kGroupChunks = 8;   // chunks of a wide head's column group (512 columns)
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

// ---------------------------------------------------------------------------
// Wide heads (d > kMaxHeadDim)
//
// d is cut into ncd = ceil(d / 64) chunks. A chunk of a tile of R rows is
// staged as R rows of 128 bytes, 128B-swizzled (the 16-byte unit u of row r
// at unit u ^ (r & 7)), the layout that the TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B and that `wgmma` reads through a descriptor, and
// from which `ldmatrix` reads 8 rows of one unit without bank conflicts.
// Where d is a multiple of 8 the TMA stages it (4-D map [B, L, H, d], box 64
// columns x R rows, columns past d and rows past L zero-filled; completion
// on an mbarrier); any other d element by element, into the same layout. The columns of the
// output go in groups of up to kGroupChunks chunks, one CTA per (row tile,
// group), and the CTA sums S (and dP) over every chunk of d once per tile
// pair: with a single group (d <= 512) exactly once, above it once per
// group.

constexpr int kChunkRowBytes = 128;  // one row of a staged chunk
constexpr int kStepChunks = 4;       // chunks a step stages above 512 columns
constexpr int kMaxStages = 4;        // ring slots
// the shared memory a CTA may take (227 KB) less its static barriers
constexpr int kSmemBudget = 227 * 1024 - 1024;

// column groups of a wide head, and chunks of the widest
__host__ __device__ inline int wide_chunks(int d) { return (d + kWideCols - 1) / kWideCols; }
__host__ __device__ inline int wide_groups(int d) {
  return (wide_chunks(d) + kGroupChunks - 1) / kGroupChunks;
}

// One launch's staging plan, computed on the host (plan_wide) and passed by
// value. A CTA sweeps tiles of the other operand ("swept": K/V for K1 and
// dQ, Q/dO for dK/dV) against its own rows ("own": Q, or K/V for dK/dV).
// Each swept tile takes `ssteps` S steps, each staging `cps` chunks of d
// (of the swept rows; of the own rows too where these are not resident),
// then `osteps` output steps, each staging `ocps` chunks of the group of
// the swept rows the output reads (none where the S step's chunks are the
// output's: K2 up to 512 columns). The own rows stay resident wherever they
// fit beside two slots: up to 512 columns all of d is one S step, above it
// the steps take kStepChunks chunks.
struct WidePlan {
  int ncd;         // chunks of d
  int groups;      // column groups
  int gchunks;     // chunks of a full group (the last may have fewer)
  int resident;    // own rows resident
  int cps;         // chunks of d an S step stages
  int ssteps;      // S steps per swept tile
  int ocps;        // chunks of the group an output step stages
  int osteps;      // output steps per swept tile (0: the S step's chunks serve)
  int stages;      // ring slots
  int slot_bytes;  // one slot, a multiple of 1024
  int own_bytes;   // the resident own rows (0 when streamed)
  int x_bytes;     // the exchange of partial sums between warps
  int smem_bytes;  // dynamic shared memory, with 1 KB of alignment slack
};

// The plan at head dim d for a staged chunk of `own` bytes (all own
// tensors), `swept` bytes (the swept tensors S reads) and `out` bytes (the
// swept tensors the output reads), `fusable` where the output reads the S
// step's own swept chunks, and x_bytes of exchange. False where no slot
// fits.
__host__ inline bool plan_wide(WidePlan& p, int d, int own, int swept, int out, bool fusable,
                               int x_bytes) {
  p.ncd = wide_chunks(d);
  p.groups = wide_groups(d);
  p.gchunks = (p.ncd + p.groups - 1) / p.groups;
  p.x_bytes = (x_bytes + 1023) / 1024 * 1024;
  const int fixed = 1024 + p.x_bytes;
  int slot;
  if (p.ncd <= kGroupChunks) {  // one group, one S step
    p.resident = 1;
    p.cps = p.ncd;
    p.ocps = p.gchunks;
    p.osteps = fusable ? 0 : 1;
    slot = p.ncd * swept > p.osteps * p.gchunks * out ? p.ncd * swept : p.gchunks * out;
  } else {
    p.ocps = kStepChunks;
    p.osteps = (p.gchunks + kStepChunks - 1) / kStepChunks;
    const int res = kStepChunks * (swept > out ? swept : out);
    p.resident = fixed + p.ncd * own + 2 * res <= kSmemBudget;
    p.cps = p.resident ? kStepChunks : kStepChunks / 2;
    const int stream = p.cps * (own + swept);
    slot = p.resident ? res : stream > kStepChunks * out ? stream : kStepChunks * out;
  }
  p.ssteps = (p.ncd + p.cps - 1) / p.cps;
  p.slot_bytes = (slot + 1023) / 1024 * 1024;
  p.own_bytes = p.resident ? p.ncd * own : 0;
  p.stages = (kSmemBudget - fixed - p.own_bytes) / p.slot_bytes;
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  p.smem_bytes = fixed + p.own_bytes + p.stages * p.slot_bytes;
  return p.stages >= 1;
}

// the byte offset of 16-byte unit u of row r in a swizzled chunk tile
__device__ __forceinline__ uint32_t swz(int r, int u) {
  return r * kChunkRowBytes + (((u ^ r) & 7) << 4);
}

// What stage_tiles reads for one chunk tile: rows 0..valid-1 and columns
// 0..cols-1 of src (row pitch ld), the rest of the tile zero.
struct TileSrc {
  const bf16* src;
  int64_t ld;
  int valid, cols;
};

// Stage `ntiles` swizzled chunk tiles of 2^row_shift rows each, tile k at
// dst + k * 2^row_shift * 128 from info(k), element by element, by every
// thread of the CTA with kDepth loads in flight before it stores them.
template <int kDepth, typename Info>
__device__ __forceinline__ void stage_tiles(unsigned char* dst, int ntiles, int row_shift,
                                            Info info) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int n = kWideCols << row_shift;  // elements of a tile
  for (int k = 0; k < ntiles; ++k) {
    const TileSrc t = info(k);
    unsigned char* const tile = dst + k * (kChunkRowBytes << row_shift);
    for (int e0 = tid; e0 < n; e0 += kDepth * nthreads) {
      bf16 v[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int e = e0 + u * nthreads, r = e >> 6, c = e & 63;
        v[u] = e < n && r < t.valid && c < t.cols ? t.src[r * t.ld + c] : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int e = e0 + u * nthreads;
        if (e < n)
          *reinterpret_cast<bf16*>(tile + swz(e >> 6, (e & 63) >> 3) + (e & 7) * 2) = v[u];
      }
    }
  }
}

// How a wide bf16 launch stages its chunks: the TMA (d a multiple of 8) or
// element by element.
enum WideStaging : int { kStageElements = 0, kStageTma = 1 };

// fp32 chunks (the CUDA-core wide kernels): rows of 64 floats at a pitch
// of kF32Pitch, so that 32 rows read at one column fall in 32 banks.
constexpr int kF32Pitch = kWideCols + 1;

// Stage rows 0..rows-1 of 64 columns of fp32, row r < valid and column
// c < cols from src[r * ld + c], the rest zero, by all the CTA's threads:
// 16-byte loads where src, the row pitch and cols allow, each thread with
// several loads in flight before it stores them.
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int64_t ld, int rows,
                                          int valid, int cols) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (((reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(ld) * 4 | cols * 4) & 15) == 0) {
    const int n = rows * (kWideCols / 4);
    for (int e0 = tid; e0 < n; e0 += 4 * nthreads) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * nthreads, r = e >> 4, c = (e & 15) * 4;
        v[u] = e < n && r < valid && c < cols ? *reinterpret_cast<const float4*>(src + r * ld + c)
                                              : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * nthreads;
        if (e >= n) continue;
        float* const t = dst + (e >> 4) * kF32Pitch + (e & 15) * 4;
        t[0] = v[u].x;
        t[1] = v[u].y;
        t[2] = v[u].z;
        t[3] = v[u].w;
      }
    }
  } else {
    const int n = rows * kWideCols;
    for (int e0 = tid; e0 < n; e0 += 8 * nthreads) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * nthreads, r = e >> 6, c = e & 63;
        v[u] = e < n && r < valid && c < cols ? src[r * ld + c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * nthreads;
        if (e < n) dst[(e >> 6) * kF32Pitch + (e & 63)] = v[u];
      }
    }
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// expect `bytes` more on `bar` (one thread, before its TMA copies)
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// one TMA copy of a box of a [B, L, H, d] map (wide_map) into shared memory
__device__ __forceinline__ void tma_chunk(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int col, int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(h), "r"(row),
      "r"(b)
      : "memory");
}

// generic-proxy stores to shared memory, made visible to wgmma and the TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ldmatrix addresses in a swizzled chunk tile `tile` (a shared address):
// the A fragment of 16 rows from row0 at k16 step kt of the chunk
__device__ __forceinline__ uint32_t swz_a(uint32_t tile, int row0, int kt) {
  const int lane = threadIdx.x & 31;
  return tile + swz(row0 + (lane & 15), 2 * kt + (lane >> 4));
}
// the B fragments for A B^T: rows n0..n0+15 of the tile are the n dimension
__device__ __forceinline__ uint32_t swz_bt(uint32_t tile, int n0, int kt) {
  const int lane = threadIdx.x & 31;
  return tile + swz(n0 + (lane & 7) + ((lane >> 4) << 3), 2 * kt + ((lane >> 3) & 1));
}
// the B fragments (ldmatrix.trans) for A T: rows k0..k0+15 of the tile are
// the reduction, its columns 8 nt .. 8 nt + 15 the n dimension (nt even)
__device__ __forceinline__ uint32_t swz_t(uint32_t tile, int k0, int nt) {
  const int lane = threadIdx.x & 31;
  return tile + swz(k0 + (lane & 7) + ((lane >> 3) & 1) * 8, nt + (lane >> 4));
}

// c (+)= A B^T over one chunk (4 k16 steps): A the 16 rows from arow0 of
// chunk tile `at`, B the kN * 8 rows from n0 of chunk tile `bt`
template <int kN>
__device__ __forceinline__ void chunk_abt(float (&c)[kN][4], uint32_t at, int arow0,
                                          uint32_t bt, int n0) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    uint32_t a[4];
    ldsm_x4(a, swz_a(at, arow0, kt));
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) {
      uint32_t b[4];
      ldsm_x4(b, swz_bt(bt, n0 + 16 * j, kt));
      mma16816(c[2 * j], a, b[0], b[1]);
      mma16816(c[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// acc (+)= A T over the 64 columns of chunk tile `tile`, for a 16x16 A
// fragment whose columns are the tile's rows k0..k0+15
__device__ __forceinline__ void chunk_at(float (&acc)[8][4], const uint32_t (&a)[4],
                                         uint32_t tile, int k0) {
#pragma unroll
  for (int nt = 0; nt < 8; nt += 2) {
    uint32_t b[4];
    ldsm_x4_t(b, swz_t(tile, k0, nt));
    mma16816(acc[nt], a, b[0], b[1]);
    mma16816(acc[nt + 1], a, b[2], b[3]);
  }
}

// --- the online softmax and the epilogue, on accumulators of 16 rows of a
// warp (row g = lane / 4 in [i][0..1], row g + 8 in [i][2..3] of each n8
// tile i; mma.sync's and wgmma's layouts alike) ---

// the columns kbase + 8 i + 2 (lane % 4) + {0, 1} at or past `limit` to -inf
template <int kN>
__device__ __forceinline__ void mask_cols(float (&s)[kN][4], int kbase, int limit) {
  const int lane = threadIdx.x & 31;
  if (kbase + 8 * kN <= limit) return;
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (kbase + 8 * i + 2 * (lane & 3) + (e & 1) >= limit) s[i][e] = -INFINITY;
}

// One tile of the online softmax in base 2 (logits times sl2 = scale
// log2(e)): the running max m and this lane's part of the running sum l of
// rows g and g + 8 move on, s becomes P (unnormalised), and alpha is the
// factor by which the rows' earlier sums shrink. Every tile holds a column
// below the limit, so the max is finite.
template <int kN>
__device__ __forceinline__ void softmax_tile(float (&s)[kN][4], float (&m)[2], float (&l)[2],
                                             float sl2, float (&alpha)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    mx[0] = fmaxf(mx[0], fmaxf(s[i][0], s[i][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[i][2], s[i][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * sl2);
    alpha[r] = ex2(m[r] - m_new);  // 0 on the first tile
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[i][e], sl2, -m[e >> 1]));  // masked: ex2(-inf) = 0
      s[i][e] = p;
      l[e >> 1] += p;
    }
}

// rows g and g + 8 of an accumulator times alpha[0] and alpha[1]
template <int kN>
__device__ __forceinline__ void scale_rows(float (&acc)[kN][4], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    acc[i][0] *= alpha[0];
    acc[i][1] *= alpha[0];
    acc[i][2] *= alpha[1];
    acc[i][3] *= alpha[1];
  }
}

// the row sums over the quad of lanes that shares a row, and their inverse
__device__ __forceinline__ void finish_rows(float (&l)[2], float (&inv)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
}

// --- wgmma: warpgroup products of 64 rows (4 warps, 16 rows each, in the
// accumulator layout above), n = 64, k = 16, bf16 operands, fp32 sums ---

// The descriptor of a swizzled chunk tile at shared address `addr`: 128B
// swizzle; 8-row groups 1024 bytes apart (SBO). LBO, the stride between
// 64-column atoms along a transposed operand's n, is never crossed by an
// n = 64 product and is set to the same 1024.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep reads of an accumulator after the wait that completes it
__device__ __forceinline__ void fence_acc(float (&d)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

#define FLASH_WG_D(d)                                                                     \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]),           \
      "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),           \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),           \
      "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]),           \
      "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define FLASH_WG_REGS                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B^T, A (64 x 16) and B (64 x 16) both from K-major chunk tiles
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_WG_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FLASH_WG_D(d)
      : "l"(da), "l"(db), "r"(1));
}

// d (+)= A B, A (64 x 16) from registers (mma.sync's A fragment in each
// warp), B (16 x 64) from a chunk tile whose rows are the reduction
// (transposed: n is the tile's contiguous dimension)
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_WG_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FLASH_WG_D(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef FLASH_WG_D
#undef FLASH_WG_REGS

// --- tensor maps (host) ---

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, through the runtime (no -lcuda)
__host__ inline EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                           12000, cudaEnableDefault, &found);
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// The map of a bf16 [B, L, H*d] tensor at `base` (batch and row strides
// sb, sl in elements, 16-byte aligned as the wrapper checks; d a multiple
// of 8) as [B, L, H, d], for boxes of one chunk of `rows` rows of one head,
// 128B-swizzled; columns past d and rows past L read as zero. A stride of
// a dimension of extent 1 is never used, and is replaced by a valid one.
__host__ inline bool wide_map(CUtensorMap* map, const void* base, int B, int L, int H, int d,
                              int64_t sb, int64_t sl, int rows) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t es = sizeof(bf16);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = L > 1 ? static_cast<cuuint64_t>(sl) * es : dims[0] * dims[1] * es;
  const cuuint64_t strides[3] = {dims[0] * es, row,
                                 B > 1 ? static_cast<cuuint64_t>(sb) * es : row * dims[2]};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kWideCols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raise a wide kernel's dynamic shared memory limit to kSmemBudget, which
// every plan_wide plan fits (the callers keep the result in a static: once
// per process); the launch is refused where the card has less.
template <typename Kernel>
__host__ inline cudaError_t allow_wide_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
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
