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
// Wide heads, d > 256 (flash_fwd_wide_{bf16,fp32}_kernel, one instantiation
// each at flash_mma::kWideCols = 64): the JAX kernel runs one head per
// matmul there. Here d is cut into nc = ceil(d / 64) chunks. A CTA owns one
// 64-column block of `out` for its query rows. For each key tile it sums S
// = sum_c Q_c K_c^T over the chunks c, each staged in shared memory, runs
// the online softmax, then stages its own 64 columns of V for O += P V.
// Nothing wider than one chunk is held in registers or shared memory, so
// any d runs (36 KB of static shared memory in bf16, 8 KB in fp32). The
// price: the nc CTAs of a query tile each recompute all of S, nc times the
// QK^T work of one pass (at d = 384, 6 S products for every P V; at 1024,
// 16). Every block computes the same row max and sum; block 0 alone writes
// `lse`. bf16: 4 warps, 64-row query tiles, 64-key tiles; each key tile
// takes nc + 1 steps of a 2-stage cp.async pipeline (nc Q/K chunk pairs,
// then V), so the copy of each step overlaps the products of the one
// before. fp32: 128 threads, 4 a query row (32 rows a CTA), 32-key tiles;
// q's chunk goes into registers, K's chunk and then V's block through one
// shared tile.

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

// fp32 wide heads: threads, threads per query row, query rows and keys of
// a CTA's tiles
struct WideFp32 {
  static constexpr int kThreads = 128;
  static constexpr int kSplit = 4;
  static constexpr int kRows = kThreads / kSplit;
  static constexpr int kKeys = 32;
};

template <int W>
__global__ void __launch_bounds__(WideFp32::kThreads)
flash_fwd_wide_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           float* __restrict__ lse, int Lq, int Lk, int H, int d,
                           int64_t q_sb, int64_t q_sl, int64_t k_sb, int64_t k_sl,
                           int64_t v_sb, int64_t v_sl, float scale) {
  using C = WideFp32;
  constexpr int kCols = W / C::kSplit;    // columns of a chunk a thread owns
  __shared__ float ks[C::kKeys][W];       // a chunk of K, then this block's V

  const int tid = threadIdx.x;
  const int part = tid % C::kSplit;  // this thread's columns: kSplit * t + part
  const int nc = (d + W - 1) / W;    // chunks of d, and column blocks of out
  const GridIdx g = flash_mma::grid_idx((Lq + C::kRows - 1) / C::kRows * nc, H);
  const int cb = g.tile % nc;
  const int row = g.tile / nc * C::kRows + tid / C::kSplit;
  const int h = g.h;
  const int64_t b = g.b;
  // rows past Lq compute on a copy of the last row and write nothing
  const int64_t qrow = row < Lq ? row : Lq - 1;
  const float* qp = q + b * q_sb + qrow * q_sl + h * d;
  const float* kb = k + b * k_sb + h * d;
  const float* vb = v + b * v_sb + h * d + cb * W;
  const int ocols = min(W, d - cb * W);  // this block's columns of out

  float acc[kCols];
#pragma unroll
  for (int t = 0; t < kCols; ++t) acc[t] = 0.f;
  float m = -INFINITY;  // running max of the logits
  float l = 0.f;        // running sum of exp(logit - m)

  for (int k0 = 0; k0 < Lk; k0 += C::kKeys) {
    // this thread's partial logits over its columns of every chunk of d
    float s[C::kKeys];
#pragma unroll
    for (int j = 0; j < C::kKeys; ++j) s[j] = 0.f;
    for (int c0 = 0; c0 < d; c0 += W) {
      float qr[kCols];
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const int c = c0 + C::kSplit * t + part;
        qr[t] = c < d ? qp[c] * scale : 0.f;
      }
      __syncthreads();  // every thread is done with the previous tile
      for (int e = tid; e < C::kKeys * W; e += C::kThreads) {
        const int j = e / W;
        const int c = e - j * W;
        const int64_t key = k0 + j;
        ks[j][c] = key < Lk && c0 + c < d ? kb[key * k_sl + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < C::kKeys; ++j)
#pragma unroll
        for (int t = 0; t < kCols; ++t) s[j] = fmaf(qr[t], ks[j][C::kSplit * t + part], s[j]);
    }

    // every tile holds at least one key < Lk, so tile_max is finite
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < C::kKeys; ++j) {
      const float dot = row_sum<C::kSplit>(s[j]);
      s[j] = (k0 + j < Lk) ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);  // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int t = 0; t < kCols; ++t) acc[t] *= alpha;

    __syncthreads();
    for (int e = tid; e < C::kKeys * W; e += C::kThreads) {
      const int j = e / W;
      const int c = e - j * W;
      const int64_t key = k0 + j;
      ks[j][c] = key < Lk && c < ocols ? vb[key * v_sl + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < C::kKeys; ++j) {
      const float p = expf(s[j] - m_new);  // masked keys give exp(-inf) = 0
      l += p;
#pragma unroll
      for (int t = 0; t < kCols; ++t) acc[t] = fmaf(p, ks[j][C::kSplit * t + part], acc[t]);
    }
    m = m_new;
  }

  if (row < Lq) {
    const float inv = 1.f / l;
    float* op = out + (b * Lq + row) * (int64_t)H * d + h * d + cb * W;
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int c = C::kSplit * t + part;
      if (c < ocols) op[c] = acc[t] * inv;
    }
    if (cb == 0 && part == 0) lse[(b * Lq + row) * H + h] = m + logf(l);
  }
}

template <int W>
__global__ void __launch_bounds__(flash_mma::kThreads)
flash_fwd_wide_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           float* __restrict__ lse, int Lq, int Lk, int H, int d,
                           int64_t q_sb, int64_t q_sl, int64_t k_sb, int64_t k_sl,
                           int64_t v_sb, int64_t v_sl, float scale) {
  using namespace flash_mma;
  using P = Dims<W>;
  constexpr int kKeys = kTile;   // keys per tile
  constexpr int kN = kKeys / 8;  // n8 tiles of keys
  // stage st: a chunk of Q in [st][0] and of K in [st][1], or V's block in [st][1]
  __shared__ __align__(16) bf16 smem[2][2][P::kTileElems];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nc = (d + W - 1) / W;  // chunks of d, and column blocks of out
  const GridIdx g = grid_idx((Lq + kTile - 1) / kTile * nc, H);
  const int cb = g.tile % nc;
  const int q0 = g.tile / nc * kTile;
  const int h = g.h;
  const int64_t b = g.b;
  const bool vec = (d & 7) == 0;
  const bf16* qb = q + b * q_sb + q0 * q_sl + h * d;
  const bf16* kb = k + b * k_sb + h * d;
  const bf16* vb = v + b * v_sb + h * d + cb * W;
  const int qrows = min(kTile, Lq - q0);
  const int ocols = min(W, d - cb * W);  // this block's columns of out
  const int per = nc + 1;                // steps per key tile
  const int steps = (Lk + kKeys - 1) / kKeys * per;

  // issue the copies of step `i` into stage st: step c < nc of a key tile
  // stages chunk c of Q and K, step nc V's block
  auto issue = [&](int i, int st) {
    const int n = i / per, c = i - n * per;
    const int k0 = n * kKeys, rows = min(kKeys, Lk - k0);
    if (c < nc) {
      const int cols = min(W, d - c * W);
      load_chunk<W, kTile>(smem[st][0], qb + c * W, q_sl, qrows, cols, vec);
      load_chunk<W, kKeys>(smem[st][1], kb + k0 * k_sl + c * W, k_sl, rows, cols, vec);
    } else {
      load_chunk<W, kKeys>(smem[st][1], vb + k0 * v_sl, v_sl, rows, ocols, vec);
    }
  };

  const float sl2 = scale * kLog2e;  // logits -> base-2 exponents
  float o[P::kN8][4] = {};
  float s[kN][4];
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g+8 (base 2)
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
  issue(0, 0);
  cp_async_commit();
  for (int i = 0; i < steps; ++i) {
    const int st = i & 1;
    if (i + 1 < steps) {
      issue(i + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int n = i / per, c = i - n * per;
    if (c < nc) {
      // S += Q_c K_c^T for this warp's 16 rows and the tile's keys
      if (c == 0) {
#pragma unroll
        for (int nt = 0; nt < kN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kN / 2; ++j)
        mma_abt_s<W>(s[2 * j], s[2 * j + 1], smem[st][0], warp * 16, smem[st][1], 16 * j);
    } else {
      const int kbase = n * kKeys;
      if (kbase + kKeys > Lk) {  // the ragged last tile: keys >= Lk to -inf
#pragma unroll
        for (int nt = 0; nt < kN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kbase + nt * 8 + 2 * (lane & 3) + (e & 1) >= Lk) s[nt][e] = -INFINITY;
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
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[nt][e], sl2, -m[e >> 1]));  // masked: ex2(-inf) = 0
          s[nt][e] = p;
          l[e >> 1] += p;
        }

      // O += P V over this block's columns, P rounded to bf16 from the S
      // accumulators
#pragma unroll
      for (int j = 0; j < kN / 2; ++j) {
        if (kbase + 16 * j < Lk) {
          uint32_t a[4];
          acc_to_a(a, s[2 * j], s[2 * j + 1]);
          mma_at<W, P::kN8>(o, a, smem[st][1], 16 * j);
        }
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
  store_rows<P::kN8>(out + b * Lq * ld + h * d, ld, row0, Lq, o, inv[0], inv[1], d, cb * W);
  if (cb == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + (lane >> 2) + 8 * r;
      if (row < Lq) lse[(b * Lq + row) * H + h] = m[r] * kLn2 + logf(l[r]);
    }
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

// d > 256: the wide kernels, one CTA per column block of 64 of each row tile
int launch_wide(int dtype, const Args& a) {
  constexpr int W = flash_mma::kWideCols;
  const int nc = (a.d + W - 1) / W;
  if (dtype == 0) {
    const unsigned grid = grid_x(a.Lq, WideFp32::kRows, a, nc);
    if (!grid) return static_cast<int>(cudaErrorInvalidConfiguration);
    flash_fwd_wide_fp32_kernel<W><<<grid, WideFp32::kThreads, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lse, a.Lq, a.Lk, a.H,
        a.d, a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 1) {
    const unsigned grid = grid_x(a.Lq, flash_mma::kTile, a, nc);
    if (!grid) return static_cast<int>(cudaErrorInvalidConfiguration);
    flash_fwd_wide_bf16_kernel<W><<<grid, flash_mma::kThreads, 0, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), a.lse, a.Lq, a.Lk, a.H, a.d,
        a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

extern "C" const char* ssl_vit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
