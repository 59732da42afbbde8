// Flash-attention forward (K1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`, launched by `_fa_fwd_impl`
// in ssl_vit_video_analytics_tpu/ops/flash_attention.py. It computes the
// same thing: non-causal softmax(q k^T / sqrt(d)) v over PACKED heads
// (q/k/v are [B, L, H*d], head h owns columns [h*d, (h+1)*d)), writing
// `out` [B, Lq, H*d] in the input dtype and the per-row logsumexp of the
// scaled logits `lse` [B, Lq, H] in fp32 (the backward kernel reads it).
// Like the JAX kernel it takes any head dim: up to 256 each kernel is built
// for a width DP and runs every d up to it (flash_mma.cuh, kernel_width);
// above 256 the wide kernels below run it in chunks of 64 columns. The
// scale 1/sqrt(d) is that of the real d, from the wrapper.
//
// Both kernels walk K/V in tiles with an ONLINE softmax (running max and
// sum in fp32), so any Lk fits; the TPU kernel kept all of K/V resident in
// VMEM for one exact pass, which bounds it to Lk of a few thousand. Key
// columns >= Lk are masked in the last tile; nothing is zero-padded in
// device memory, and zero tokens that the caller put in the sequence
// (MobileViT's 7x7 -> 8x8 pad) are real keys. Inputs are strided views: the
// row stride of q/k/v is a parameter (3*H*d for the thirds of a fused qkv
// projection), the last dim is contiguous. One CTA per (query tile, head,
// batch row), all in grid.x, so the batch has no 65535 ceiling.
//
// What bounds it: about 4*Lq*Lk*d flops per (batch row, head) against
// about 4*L*d elements of traffic, so it is bound by operations at every
// shape the models use. Two kernels, by dtype:
//
// - bf16, the working type of both main paths: flash_fwd_bf16_kernel runs
//   S = Q K^T and O += P V on the tensor cores (flash_mma.cuh: mma.sync
//   m16n8k16, bf16 operands, fp32 accumulators). One CTA of 4 warps per
//   64-row query tile; each warp owns 16 query rows and, up to DP = 128,
//   keeps their Q fragments in registers for the whole sweep (at DP = 256
//   they would not fit beside the 128 registers of the output accumulators,
//   so each k16 step's fragment is read from the staged Q tile). K and V
//   come in 64-key tiles (32 at DP = 256, to keep the S accumulators and
//   the stages small) through a 2-stage pipeline, so the copy of the next
//   tile overlaps the products on this one. The softmax runs on the S
//   accumulators in fp32 registers, in base 2 (scale * log2(e) folded into
//   one multiply before ex2), with the row max and sum reduced across the
//   quad of lanes that shares a row. P is rounded to bf16 unnormalised and
//   goes from the S accumulators straight into the A fragment of P V; 1/l
//   is applied after the product, in `_fwd_kernel`'s own order.
// - fp32: flash_fwd_fp32_kernel, fp32 FMAs on the CUDA cores, one thread
//   per query row up to DP = 64, 2 threads from DP = 96 and 4 at DP = 256
//   (each owns every kSplit-th column; a dot product ends in a shuffle), so
//   that a thread's share of q and of the output stays in 128 registers.
//   TF32 tensor-core products would miss the 1e-4 to which the fp32
//   training step is held against the plain path.
//
// Wide heads, d > 256 (flash_fwd_wide_{bf16,fp32}_kernel): the JAX kernel
// runs one head per matmul there. Here d is cut into ncd = ceil(d / 64)
// chunks and the output's columns into groups of up to 8 chunks (512
// columns); one CTA per (64-row query tile, group), so up to d = 512 one CTA
// a tile, and S = Q K^T is computed once per (query tile, key tile) pair;
// above 512 once per group (twice at d = 1024). What bounds it is the same
// 4 Lq Lk d flops, for 4 L d elements of traffic.
// - bf16 (wgmma): two warpgroups, each the M = 64 of its products. S is
//   split over d: each warpgroup sums a 64 x 64 fp32 partial over its half
//   of the chunks (wgmma, Q and K both from shared memory); the two meet in
//   32 KB of shared memory, each adds the other's (IEEE addition commutes:
//   both hold the same S), and both run the same online softmax, so P needs
//   no second barrier to change hands. P, rounded to bf16, stays in
//   registers as wgmma's A operand of O += P V, each warpgroup over its half
//   of the group's columns (up to 256: 128 fp32 accumulators a thread, as the
//   narrow kernel at width 256). Q stays resident in shared memory for the
//   whole sweep wherever it fits beside two ring slots (64 KB at d = 512,
//   128 KB at 1024); past that its chunks come with K's. Every tile is
//   staged as 128B-swizzled chunks of 64 columns, the layout wgmma's
//   descriptors read; where d is a multiple of 8 the TMA copies them (a 4-D
//   map [B, L, H, d]: columns past d and rows past L read as zero) into a
//   ring of 2-4 slots of up to 64 KB, each completing on an mbarrier, so
//   the copies of the next steps overlap the products of this one (K's
//   chunks, then V's, per key tile); any other d is staged element by
//   element into the same layout. One CTA an SM (225 KB of shared memory at
//   d = 384 and 512); both warpgroups' registers hold O, S and P.
// - fp32 (CUDA cores): 256 threads, 64 query rows, 64-key tiles; each thread
//   owns a 4 x 4 block of S and of each output chunk (its rows are the same
//   in both, so the softmax's rescale stays in registers), so each value read
//   from shared memory feeds 4 FMAs. d goes one chunk of Q and K at a time,
//   then P (shared memory) and V's chunks of the group for O += P V. TF32
//   stays off: the fp32 step is held to 1e-4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using flash_mma::bf16;
using flash_mma::Dims;
using flash_mma::GridIdx;

constexpr int kFp32Threads = 64;

template <int DP>
struct Fp32Cfg {
  static constexpr int kSplit = DP <= 64 ? 1 : DP <= 128 ? 2 : 4;  // threads per row
  static constexpr int kCols = DP / kSplit;                        // columns a thread owns
  static constexpr int kRows = kFp32Threads / kSplit;              // query rows per CTA
  static constexpr int kKeys = DP <= 128 ? 32 : 16;                // keys per smem tile
};

template <int DP>
struct Bf16Cfg {
  static constexpr int kKeys = DP <= 128 ? 64 : 32;  // keys per K/V tile
  static constexpr bool kQSmem = DP > 128;           // Q fragments read from smem
  static constexpr int kStage = 2 * kKeys * Dims<DP>::kStride;  // K rows, then V rows
  static constexpr int kRows = 4 * kKeys + (kQSmem ? flash_mma::kTile : 0);
  static constexpr size_t kSmemBytes = kRows * Dims<DP>::kStride * sizeof(bf16);
};

// the sum of the partial dot products of the kSplit adjacent lanes of a row
template <int kSplit>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < kSplit; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DP>
__global__ void __launch_bounds__(kFp32Threads)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int Lq, int Lk, int H, int d,
                      int64_t q_sb, int64_t q_sl, int64_t k_sb, int64_t k_sl,
                      int64_t v_sb, int64_t v_sl, float scale) {
  using C = Fp32Cfg<DP>;
  __shared__ float ks[C::kKeys][DP];
  __shared__ float vs[C::kKeys][DP];

  const int tid = threadIdx.x;
  const int part = tid % C::kSplit;  // this thread's columns: kSplit * t + part
  const GridIdx g = flash_mma::grid_idx((Lq + C::kRows - 1) / C::kRows, H);
  const int row = g.tile * C::kRows + tid / C::kSplit;
  const int h = g.h;
  const int64_t b = g.b;
  // rows past Lq compute on a copy of the last row and write nothing
  const int64_t qrow = row < Lq ? row : Lq - 1;

  float qr[C::kCols];
  const float* qp = q + b * q_sb + qrow * q_sl + h * d;
#pragma unroll
  for (int t = 0; t < C::kCols; ++t) {
    const int c = C::kSplit * t + part;
    qr[t] = c < d ? qp[c] * scale : 0.f;
  }

  float acc[C::kCols];
#pragma unroll
  for (int t = 0; t < C::kCols; ++t) acc[t] = 0.f;
  float m = -INFINITY;  // running max of the logits
  float l = 0.f;        // running sum of exp(logit - m)

  const float* kb = k + b * k_sb + h * d;
  const float* vb = v + b * v_sb + h * d;

  for (int k0 = 0; k0 < Lk; k0 += C::kKeys) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < C::kKeys * DP; e += kFp32Threads) {
      const int j = e / DP;
      const int c = e - j * DP;
      const int64_t key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < Lk && c < d) {
        kx = kb[key * k_sl + c];
        vx = vb[key * v_sl + c];
      }
      ks[j][c] = kx;
      vs[j][c] = vx;
    }
    __syncthreads();

    // every tile holds at least one key < Lk, so tile_max is finite
    float s[C::kKeys];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < C::kKeys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < C::kCols; ++t) dot = fmaf(qr[t], ks[j][C::kSplit * t + part], dot);
      dot = row_sum<C::kSplit>(dot);
      s[j] = (k0 + j < Lk) ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);  // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int t = 0; t < C::kCols; ++t) acc[t] *= alpha;
#pragma unroll
    for (int j = 0; j < C::kKeys; ++j) {
      const float p = expf(s[j] - m_new);  // masked keys give exp(-inf) = 0
      l += p;
#pragma unroll
      for (int t = 0; t < C::kCols; ++t) acc[t] = fmaf(p, vs[j][C::kSplit * t + part], acc[t]);
    }
    m = m_new;
  }

  if (row < Lq) {
    const float inv = 1.f / l;
    float* op = out + (b * Lq + row) * (int64_t)H * d + h * d;
#pragma unroll
    for (int t = 0; t < C::kCols; ++t) {
      const int c = C::kSplit * t + part;
      if (c < d) op[c] = acc[t] * inv;
    }
    if (part == 0) lse[(b * Lq + row) * H + h] = m + logf(l);
  }
}

template <int DP>
__global__ void __launch_bounds__(flash_mma::kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, int Lq, int Lk, int H, int d,
                      int64_t q_sb, int64_t q_sl, int64_t k_sb, int64_t k_sl, int64_t v_sb,
                      int64_t v_sl, float scale) {
  using namespace flash_mma;
  using P = Dims<DP>;
  using C = Bf16Cfg<DP>;
  constexpr int kKeys = C::kKeys;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* const ks[2] = {smem, smem + C::kStage};
  bf16* const vs[2] = {smem + kKeys * P::kStride, smem + C::kStage + kKeys * P::kStride};
  // Up to DP = 128 the 64-row Q tile rides in stage 1 until its fragments
  // are in registers, before the second key tile is loaded; at DP = 256 it
  // has rows of its own for the whole sweep.
  bf16* const qs = C::kQSmem ? smem + 2 * C::kStage : ks[1];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const GridIdx g = grid_idx((Lq + kTile - 1) / kTile, H);
  const int q0 = g.tile * kTile;
  const int h = g.h;
  const int64_t b = g.b;
  const bf16* kb = k + b * k_sb + h * d;
  const bf16* vb = v + b * v_sb + h * d;

  zero_pad_columns<DP>(smem, C::kRows, d);
  load_tile<DP>(qs, q + b * q_sb + q0 * q_sl + h * d, q_sl, min(kTile, Lq - q0), d);
  load_tile<DP, kKeys>(ks[0], kb, k_sl, min(kKeys, Lk), d);
  load_tile<DP, kKeys>(vs[0], vb, v_sl, min(kKeys, Lk), d);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[C::kQSmem ? 1 : P::kK16][4];
  if constexpr (!C::kQSmem) {
    load_a<DP>(qf, qs, warp * 16);
    __syncthreads();  // every warp holds its Q before stage 1 is overwritten
  }

  const float sl2 = scale * kLog2e;  // logits -> base-2 exponents
  float o[P::kN8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g+8 (base 2)
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
  const int ntiles = (Lk + kKeys - 1) / kKeys;
  for (int n = 0; n < ntiles; ++n) {
    const int st = n & 1;
    if (n + 1 < ntiles) {
      const int k1 = (n + 1) * kKeys;
      load_tile<DP, kKeys>(ks[st ^ 1], kb + k1 * k_sl, k_sl, min(kKeys, Lk - k1), d);
      load_tile<DP, kKeys>(vs[st ^ 1], vb + k1 * v_sl, v_sl, min(kKeys, Lk - k1), d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's keys
    constexpr int kN = kKeys / 8;  // n8 tiles of keys
    float s[kN][4] = {};
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) {
      if constexpr (C::kQSmem)
        mma_abt_s<DP>(s[2 * j], s[2 * j + 1], qs, warp * 16, ks[st], 16 * j);
      else
        mma_abt<DP>(s[2 * j], s[2 * j + 1], qf, ks[st], 16 * j);
    }

    const int kbase = n * kKeys;
    if (kbase + kKeys > Lk) {  // the ragged last tile: keys >= Lk to -inf
#pragma unroll
      for (int nt = 0; nt < kN; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (kbase + nt * 8 + 2 * (lane & 3) + (i & 1) >= Lk) s[nt][i] = -INFINITY;
    }

    // online softmax; every tile holds a key < Lk, so the max is finite
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kN; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2];
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
    for (int nt = 0; nt < P::kN8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ex2(fmaf(s[nt][i], sl2, -m[i >> 1]));  // masked: ex2(-inf) = 0
        s[nt][i] = p;
        l[i >> 1] += p;
      }

    // O += P V, P rounded to bf16 straight from the S accumulators
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) {
      if (kbase + 16 * j < Lk) {
        uint32_t a[4];
        acc_to_a(a, s[2 * j], s[2 * j + 1]);
        mma_at<DP, P::kN8>(o, a, vs[st], 16 * j);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  const int row0 = q0 + warp * 16;
  const int64_t ld = static_cast<int64_t>(H) * d;
  store_rows<P::kN8>(out + b * Lq * ld + h * d, ld, row0, Lq, o, inv[0], inv[1], d);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + (lane >> 2) + 8 * r;
      if (row < Lq) lse[(b * Lq + row) * H + h] = m[r] * kLn2 + logf(l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// Wide heads, d > 256 (flash_mma.cuh, "Wide heads"): a CTA per (64-row
// query tile, column group of up to 512 columns), S summed over all of d
// once per key tile.

constexpr int kWideThreads = 256;  // bf16: two warpgroups; fp32: 8 warps
constexpr int kWideRows = 64;      // query rows of a CTA: the wgmma M
constexpr int kWideKeys = 64;      // keys of a tile
constexpr int kWideChunk = kWideRows * flash_mma::kChunkRowBytes;  // one staged chunk, 8 KB

struct WideArgs {
  const bf16 *q, *k, *v;
  bf16* out;
  float* lse;
  int Lq, Lk, H, d;
  int64_t q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;
  float scale;
  int mode;  // flash_mma::WideStaging
  flash_mma::WidePlan p;
};

// bf16: warpgroup wg owns the group's output chunks wg, wg + 2, ... (up to
// 4: 256 columns) and sums its part of S, the chunks i = wg, wg + 2, ... of
// each S step, on wgmma into a 64 x 64 fp32 partial. The two partials meet
// in shared memory (x: one 16 KB half a warpgroup, thread-major), and each
// warpgroup adds the other's to its own: IEEE addition commutes, so both
// hold the same S bit for bit and run the same softmax, with no second
// barrier to hand P over. P, rounded to bf16, stays in registers as the A
// operand of O += P V (wgmma, V's chunk transposed through the descriptor)
// for every V step of the key tile.
__global__ void __launch_bounds__(kWideThreads, 1)
flash_fwd_wide_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, const WideArgs a) {
  using namespace flash_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[kMaxStages + 1];  // ring slots, then resident Q
  const WidePlan& p = a.p;
  unsigned char* const base = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* const qres = base;  // resident Q: chunk c at c
  unsigned char* const ring = base + p.own_bytes;
  float* const x = reinterpret_cast<float*>(ring + p.stages * p.slot_bytes);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const GridIdx gi = grid_idx((a.Lq + kWideRows - 1) / kWideRows * p.groups, a.H);
  const int grp = gi.tile % p.groups;
  const int q0 = gi.tile / p.groups * kWideRows;
  const int h = gi.h;
  const int64_t b = gi.b;
  const int cg0 = grp * p.gchunks, ncg = min(p.gchunks, p.ncd - cg0);
  const int per = p.ssteps + p.osteps;  // S steps, then V's
  const int steps = (a.Lk + kWideKeys - 1) / kWideKeys * per;
  const int qrows = min(kWideRows, a.Lq - q0);
  const bf16* const qb = a.q + b * a.q_sb + h * a.d;  // the head's row 0
  const bf16* const kb = a.k + b * a.k_sb + h * a.d;
  const bf16* const vb = a.v + b * a.v_sb + h * a.d;

  // issue step i into its slot: S step s stages K's chunks s cps .. (and
  // Q's, Q and K of chunk j at 2j, 2j + 1, where Q is not resident), V step
  // o V's chunks o ocps .. of the group; by the TMA (one thread), or by
  // every thread element by element
  auto issue = [&](int i) {
    const int slot = i % p.stages;
    unsigned char* const dst = ring + slot * p.slot_bytes;
    uint64_t* const bar = &bars[slot];
    const int n = i / per, s = i - n * per;
    const int k0 = n * kWideKeys, krows = min(kWideKeys, a.Lk - k0);
    const bool vstep = s >= p.ssteps, withq = !vstep && !p.resident;
    const int c0 = vstep ? cg0 + (s - p.ssteps) * p.ocps : s * p.cps;
    const int cn = vstep ? min(p.ocps, cg0 + ncg - c0) : min(p.cps, p.ncd - c0);
    auto info = [&](int t) {
      const int c = c0 + (withq ? t >> 1 : t);
      const bool q = withq && !(t & 1);
      const bf16* const src = q ? qb + q0 * a.q_sl : vstep ? vb + k0 * a.v_sl : kb + k0 * a.k_sl;
      return TileSrc{src + c * kWideCols, q ? a.q_sl : vstep ? a.v_sl : a.k_sl,
                     q ? qrows : krows, min(kWideCols, a.d - c * kWideCols)};
    };
    if (a.mode == kStageElements) {
      stage_tiles<8>(dst, (withq ? 2 : 1) * cn, 6, info);
      return;
    }
    if (tid != 0) return;
    mbar_expect(bar, (withq ? 2 : 1) * cn * kWideChunk);
    for (int j = 0; j < cn; ++j) {
      const int c = (c0 + j) * kWideCols;
      if (vstep) {
        tma_chunk(dst + j * kWideChunk, &vmap, bar, c, h, k0, static_cast<int>(b));
      } else if (!withq) {
        tma_chunk(dst + j * kWideChunk, &kmap, bar, c, h, k0, static_cast<int>(b));
      } else {
        tma_chunk(dst + 2 * j * kWideChunk, &qmap, bar, c, h, q0, static_cast<int>(b));
        tma_chunk(dst + (2 * j + 1) * kWideChunk, &kmap, bar, c, h, k0, static_cast<int>(b));
      }
    }
  };

  if (tid == 0) {
    for (int s = 0; s <= kMaxStages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto qinfo = [&](int c) {
    return TileSrc{qb + q0 * a.q_sl + c * kWideCols, a.q_sl, qrows,
                   min(kWideCols, a.d - c * kWideCols)};
  };
  if (p.resident && a.mode == kStageElements) {
    stage_tiles<8>(qres, p.ncd, 6, qinfo);
  } else if (p.resident && tid == 0) {
    mbar_expect(&bars[kMaxStages], p.ncd * kWideChunk);
    for (int c = 0; c < p.ncd; ++c)
      tma_chunk(qres + c * kWideChunk, &qmap, &bars[kMaxStages], c * kWideCols, h, q0,
                static_cast<int>(b));
  }
  for (int i = 0; i < p.stages && i < steps; ++i) issue(i);
  if (a.mode == kStageElements) {
    fence_proxy_async();
    __syncthreads();
  } else if (a.mode == kStageTma && p.resident) {
    mbar_wait(&bars[kMaxStages], 0);
  }

  const float sl2 = a.scale * kLog2e;  // logits -> base-2 exponents
  float o[4][8][4] = {};
  float sacc[8][4];
  uint32_t pa[4][4];  // P, rounded to bf16, as the A fragments of 4 k16 steps
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g+8 (base 2)
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
  for (int i = 0; i < steps; ++i) {
    const int slot = i % p.stages;
    unsigned char* const cur = ring + slot * p.slot_bytes;
    if (a.mode == kStageTma) mbar_wait(&bars[slot], (i / p.stages) & 1);
    const int n = i / per, s = i - n * per;
    if (s < p.ssteps) {
      // this warpgroup's part of S = Q K^T: the step's chunks wg, wg + 2, ...
      if (s == 0) {
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[t][e] = 0.f;
      }
      const int c0 = s * p.cps, cn = min(p.cps, p.ncd - c0);
      wgmma_fence();
      for (int j = wg; j < cn; j += 2) {
        const uint32_t qa = smem_addr(p.resident ? qres + (c0 + j) * kWideChunk
                                                 : cur + 2 * j * kWideChunk);
        const uint32_t ka = smem_addr(cur + (p.resident ? j : 2 * j + 1) * kWideChunk);
#pragma unroll
        for (int kt = 0; kt < 4; ++kt)
          wgmma_ss(sacc, wgmma_desc(qa + 32 * kt), wgmma_desc(ka + 32 * kt));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(sacc);
      if (s == p.ssteps - 1) {  // the partial, for the other warpgroup
        float* const mine = x + wg * 32 * 128;
#pragma unroll
        for (int e = 0; e < 32; ++e) mine[e * 128 + wt] = sacc[e >> 2][e & 3];
      }
    } else {
      const int ov = s - p.ssteps;  // V step
      if (ov == 0) {
        const float* const other = x + (wg ^ 1) * 32 * 128;
#pragma unroll
        for (int e = 0; e < 32; ++e) sacc[e >> 2][e & 3] += other[e * 128 + wt];
        mask_cols<8>(sacc, n * kWideKeys, a.Lk);  // the ragged last tile: keys >= Lk to -inf
        float alpha[2];
        softmax_tile<8>(sacc, m, l, sl2, alpha);
#pragma unroll
        for (int oc = 0; oc < 4; ++oc)
          if (wg + 2 * oc < ncg) scale_rows<8>(o[oc], alpha);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_to_a(pa[j], sacc[2 * j], sacc[2 * j + 1]);
      }
      // O += P V over this warpgroup's chunks among the step's
      const int g0 = ov * p.ocps, gn = min(p.ocps, ncg - g0);
      wgmma_fence();
#pragma unroll
      for (int oc = 0; oc < 4; ++oc) {
        const int g = wg + 2 * oc - g0;  // the chunk's place in the step
        if (g >= 0 && g < gn) {
          const uint32_t va = smem_addr(cur + g * kWideChunk);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wgmma_rs(o[oc], pa[j], wgmma_desc(va + j * 16 * kChunkRowBytes));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int oc = 0; oc < 4; ++oc) fence_acc(o[oc]);
    }
    __syncthreads();  // every warp is done with this slot (and with x)
    if (i + p.stages < steps) {
      issue(i + p.stages);
      if (a.mode == kStageElements) {
        fence_proxy_async();
        __syncthreads();
      }
    }
  }

  float inv[2];
  finish_rows(l, inv);
  const int row0 = q0 + warp * 16;
  const int64_t ld = static_cast<int64_t>(a.H) * a.d;
  bf16* const ob = a.out + b * a.Lq * ld + h * a.d;
#pragma unroll
  for (int oc = 0; oc < 4; ++oc)
    if (wg + 2 * oc < ncg)
      store_rows<8>(ob, ld, row0, a.Lq, o[oc], inv[0], inv[1], a.d,
                    (cg0 + wg + 2 * oc) * kWideCols);
  if (wg == 0 && grp == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + (lane >> 2) + 8 * r;
      if (row < a.Lq) a.lse[(b * a.Lq + row) * a.H + h] = m[r] * kLn2 + logf(l[r]);
    }
  }
}

// fp32: the same CTA geometry on the CUDA cores. Every thread owns a 4 x 4
// block of S (rows 8 warp + lane / 16 + 2 i, keys lane % 16 + 16 j) and of
// each output chunk (the same rows, columns lane % 16 + 16 j), so each
// value read from shared memory feeds 4 FMAs, and a row's max and sum are
// reduced over the 16 lanes that share it. d goes one chunk at a time (Q's
// and K's chunk staged together); S is summed over every chunk once per key
// tile, then P goes to shared memory and V's chunks of the group come in
// turn for O += P V.
__global__ void __launch_bounds__(kWideThreads, 1)
flash_fwd_wide_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           float* __restrict__ lse, int Lq, int Lk, int H, int d,
                           int64_t q_sb, int64_t q_sl, int64_t k_sb, int64_t k_sl,
                           int64_t v_sb, int64_t v_sl, float scale) {
  using namespace flash_mma;
  __shared__ float qs[kWideRows * kF32Pitch];  // Q's chunk, then P
  __shared__ float ks[kWideKeys * kF32Pitch];  // K's chunk, then V's

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kq = lane & 15, r0 = 8 * warp + (lane >> 4);  // rows r0 + 2 i, keys kq + 16 j
  const int ncd = wide_chunks(d), groups = wide_groups(d);
  const int gchunks = (ncd + groups - 1) / groups;
  const GridIdx gi = grid_idx((Lq + kWideRows - 1) / kWideRows * groups, H);
  const int grp = gi.tile % groups, q0 = gi.tile / groups * kWideRows;
  const int h = gi.h;
  const int64_t b = gi.b;
  const int cg0 = grp * gchunks, ncg = min(gchunks, ncd - cg0);
  const int qrows = min(kWideRows, Lq - q0);
  const float* const qb = q + b * q_sb + q0 * q_sl + h * d;
  const float* const kb = k + b * k_sb + h * d;
  const float* const vb = v + b * v_sb + h * d;

  float o[kGroupChunks][4][4] = {};
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += kWideKeys) {
    const int krows = min(kWideKeys, Lk - k0);
    float s[4][4] = {};
    for (int c = 0; c < ncd; ++c) {
      const int cols = min(kWideCols, d - c * kWideCols);
      __syncthreads();  // every thread is done with the tiles
      stage_f32(qs, qb + c * kWideCols, q_sl, kWideRows, qrows, cols);
      stage_f32(ks, kb + k0 * k_sl + c * kWideCols, k_sl, kWideKeys, krows, cols);
      __syncthreads();
#pragma unroll 4
      for (int t = 0; t < kWideCols; ++t) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(r0 + 2 * i) * kF32Pitch + t];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = ks[(kq + 16 * j) * kF32Pitch + t];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
    // the online softmax of each row; every tile holds a key < Lk
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = k0 + kq + 16 * j < Lk ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o2 = 1; o2 < 16; o2 <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);  // masked keys give exp(-inf) = 0
        l[i] += s[i][j];
      }
#pragma unroll
      for (int oc = 0; oc < kGroupChunks; ++oc)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[oc][i][j] *= alpha;
    }
    __syncthreads();  // every thread is done with Q's and K's chunks
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) qs[(r0 + 2 * i) * kF32Pitch + kq + 16 * j] = s[i][j];
#pragma unroll
    for (int oc = 0; oc < kGroupChunks; ++oc) {
      if (oc >= ncg) break;
      const int c = cg0 + oc;
      if (oc > 0) __syncthreads();  // every thread is done with the last chunk of V
      stage_f32(ks, vb + k0 * v_sl + c * kWideCols, v_sl, kWideKeys, krows,
                min(kWideCols, d - c * kWideCols));
      __syncthreads();
#pragma unroll 4
      for (int t = 0; t < kWideKeys; ++t) {
        float pv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = qs[(r0 + 2 * i) * kF32Pitch + t];
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = ks[t * kF32Pitch + kq + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[oc][i][j] = fmaf(pv[i], vv[j], o[oc][i][j]);
      }
    }
  }

  const int64_t ld = static_cast<int64_t>(H) * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float sum = l[i];
#pragma unroll
    for (int o2 = 1; o2 < 16; o2 <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o2);
    const int row = q0 + r0 + 2 * i;
    if (row >= Lq) continue;
    const float inv = 1.f / sum;
    float* const op = out + (b * Lq + row) * ld + h * d;
#pragma unroll
    for (int oc = 0; oc < kGroupChunks; ++oc) {
      if (oc >= ncg) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = (cg0 + oc) * kWideCols + kq + 16 * j;
        if (col < d) op[col] = o[oc][i][j] * inv;
      }
    }
    if (grp == 0 && kq == 0) lse[(b * Lq + row) * H + h] = m[i] + logf(sum);
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  float* lse;
  int B, Lq, Lk, H, d;
  int64_t q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;
  float scale;
  cudaStream_t stream;
};

// (tiles x split x H x B) CTAs in grid.x, or 0 past its 2^31 - 1
inline unsigned grid_x(int L, int rows, const Args& a, int split = 1) {
  const int64_t n = static_cast<int64_t>((L + rows - 1) / rows) * split * a.H * a.B;
  return n <= 0x7fffffff ? static_cast<unsigned>(n) : 0u;
}

template <int DP>
int launch_fp32(const Args& a) {
  const unsigned grid = grid_x(a.Lq, Fp32Cfg<DP>::kRows, a);
  if (!grid) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_fwd_fp32_kernel<DP><<<grid, kFp32Threads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lse, a.Lq, a.Lk, a.H,
      a.d, a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_bf16(const Args& a) {
  using C = Bf16Cfg<DP>;
  const unsigned grid = grid_x(a.Lq, flash_mma::kTile, a);
  if (!grid) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto kernel = flash_fwd_bf16_kernel<DP>;
  const cudaError_t err = flash_mma::allow_smem(kernel, C::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, flash_mma::kThreads, C::kSmemBytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), a.lse, a.Lq, a.Lk, a.H, a.d,
      a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch(int dtype, const Args& a) {
  if (dtype == 0) return launch_fp32<DP>(a);
  if (dtype == 1) return launch_bf16<DP>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 wide kernel's staging plan at head dim d: own rows Q, swept K,
// then V in steps of their own; exchanged, the two warpgroups' partial S.
bool wide_plan(flash_mma::WidePlan& p, int d) {
  return flash_mma::plan_wide(p, d, kWideChunk, kWideChunk, kWideChunk, false, 2 * 64 * 64 * 4);
}

// d > 256: the wide kernels, one CTA per (row tile, column group)
int launch_wide(int dtype, const Args& a) {
  using namespace flash_mma;
  const int groups = wide_groups(a.d);
  const unsigned grid = grid_x(a.Lq, kWideRows, a, groups);
  if (!grid) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (dtype == 0) {
    flash_fwd_wide_fp32_kernel<<<grid, kWideThreads, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lse, a.Lq, a.Lk, a.H,
        a.d, a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  WideArgs w{static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
             static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), a.lse, a.Lq, a.Lk, a.H,
             a.d, a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.scale, kStageElements,
             {}};
  if ((a.d & 7) == 0) w.mode = kStageTma;
  if (!wide_plan(w.p, a.d)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3] = {};
  if (w.mode == kStageTma &&
      !(wide_map(&maps[0], a.q, a.B, a.Lq, a.H, a.d, a.q_sb, a.q_sl, kWideRows) &&
        wide_map(&maps[1], a.k, a.B, a.Lk, a.H, a.d, a.k_sb, a.k_sl, kWideKeys) &&
        wide_map(&maps[2], a.v, a.B, a.Lk, a.H, a.d, a.v_sb, a.v_sl, kWideKeys)))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t err = allow_wide_smem(flash_fwd_wide_bf16_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_wide_bf16_kernel<<<grid, kWideThreads, w.p.smem_bytes, a.stream>>>(
      maps[0], maps[1], maps[2], w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// head_dim: any d >= 1 (above 256 the wide kernels); where d is a multiple
// of 8, bf16 q, k and v must be 16-byte aligned with strides of whole
// 16-byte chunks, as the wrapper checks. Strides are in elements. Returns
// the launch's cudaError_t.
extern "C" int ssl_vit_flash_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v, void* out, void* lse, int B,
                                 int Lq, int Lk, int H, int64_t q_sb, int64_t q_sl,
                                 int64_t k_sb, int64_t k_sl, int64_t v_sb, int64_t v_sl,
                                 float scale, void* stream) {
  const Args a{q,    k,    v,    out,  static_cast<float*>(lse), B, Lq, Lk, H, head_dim,
               q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale,
               static_cast<cudaStream_t>(stream)};
  switch (flash_mma::kernel_width(head_dim)) {
    case 32: return launch<32>(dtype, a);
    case 40: return launch<40>(dtype, a);
    case 48: return launch<48>(dtype, a);
    case 64: return launch<64>(dtype, a);
    case 96: return launch<96>(dtype, a);
    case 128: return launch<128>(dtype, a);
    case 256: return launch<256>(dtype, a);
    default:
      return head_dim > flash_mma::kMaxHeadDim ? launch_wide(dtype, a)
                                               : static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory, in bytes, of the bf16 wide kernel at head dim
// d > 256 (0 where no plan fits).
extern "C" int ssl_vit_flash_fwd_wide_smem(int head_dim) {
  flash_mma::WidePlan p;
  return head_dim > flash_mma::kMaxHeadDim && wide_plan(p, head_dim) ? p.smem_bytes : 0;
}

extern "C" const char* ssl_vit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
