// Flash-attention backward (K2) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_bwd_kernel`, launched by `_fa_bwd_impl`
// in ssl_vit_video_analytics_tpu/ops/flash_attention.py. It computes the
// same thing: from q, k, v, dO (packed [B, L, H*d], head h owns columns
// [h*d, (h+1)*d)), the forward's per-row logsumexp of the SCALED logits
// `lse` [B, Lq, H] (K1's output) and `delta` = rowsum(dO * O) [B, Lq, H]
// (computed by the wrapper), it writes
//   P  = exp(scale * q k^T - lse)
//   dV = P^T dO
//   dS = P * (dO v^T - delta)
//   dQ = scale * dS k,   dK = scale * dS^T q
// in the input dtype (fp32 or bf16), with every sum in fp32. Like the JAX
// kernel it takes any head dim: up to 256 each kernel is built for a width
// DP and runs every d up to it (flash_mma.cuh, kernel_width); above 256 the
// wide kernels below run it in chunks of 64 columns.
//
// The TPU kernel walks the q-blocks of one batch row IN ORDER and carries
// dK/dV in VMEM scratch from one grid step to the next. CTAs run
// concurrently and in no order, so that scheme would race. Here the work is
// split FA2-style into two kernels, each of which owns its outputs:
// * dkdv: one CTA per (64-key tile, head, batch row) loops over ALL query
//   rows and keeps its keys' dK/dV accumulators in registers. Nothing is
//   shared across CTAs, so no atomics and a fixed summation order.
// * dq: one CTA per (64-row query tile, head, batch row) loops over all
//   keys, as K1 does, and keeps dQ in registers.
// S and dP are recomputed in both (7 products per tile instead of the fused
// kernel's 5); in exchange every output has exactly one writer. Keys >= Lk
// and query rows >= Lq are masked explicitly; nothing is zero-padded in
// device memory. Inputs are strided views, as in K1 (row stride 3*H*d for
// the thirds of a fused qkv projection); dO has its own strides; outputs
// are contiguous [B, L, H*d]. The CTAs of a launch are all in grid.x, so
// the batch has no 65535 ceiling.
//
// What bounds it: per (batch row, head) the backward does about
// 14*Lq*Lk*d flops against about (4*Lq + 4*Lk)*d elements of traffic per
// sweep, so it is bound by operations at every shape of the pipeline-B
// step. Two pairs of kernels, by dtype:
//
// - bf16, the working type of pretraining: every product on the tensor
//   cores (flash_mma.cuh: mma.sync m16n8k16, bf16 operands, fp32
//   accumulators), 4 warps per CTA, 16 rows each, and a 2-stage pipeline of
//   64-row tiles, so the copy of the next tile overlaps the products on
//   this one.
//   * dkdv: each warp keeps its 16 keys' K and V fragments in registers and
//     computes S^T = K Q^T and dP^T = V dO^T with the keys as the M
//     dimension, 16 query columns at a time. P^T = exp2(S^T scale log2(e) -
//     lse log2(e)) and dS^T = P^T (dP^T - D) then already sit in the
//     accumulator layout that is the A fragment of dV += P^T dO and
//     dK += dS^T Q, with dO and Q read by ldmatrix.trans. P^T and dS^T are
//     rounded to bf16 before those products, as `_bwd_kernel` rounds them.
//     Wide heads: from DP = 128 the K and V fragments are read from the
//     CTA's staged K and V tiles one k16 step at a time (beside 2 x DP/2
//     accumulator registers they would not fit), and at DP = 256 a CTA
//     accumulates one half of dK's and dV's columns (two CTAs a key tile,
//     each recomputing S^T and dP^T over all of d).
//   * dq: each warp keeps its 16 rows' Q and dO fragments in registers,
//     computes S and dP over 16 keys at a time, dS = P (dP - D) rounded to
//     bf16, and dQ += dS K with K read by ldmatrix.trans. At DP = 256 the Q
//     and dO fragments are read from their staged tiles.
// - fp32: the CUDA-core kernels, kSplit threads per row (2 up to DP = 64,
//   4 to 128, 8 at 256; thread `part` of a row owns the columns
//   c = kSplit t + part, and a dot product ends in a shuffle), fp32 FMAs.
//   TF32 tensor-core products would miss the 1e-4 to which the fp32
//   training step is held against the plain path.
//
// Wide heads, d > 256 (flash_bwd_{dkdv,dq}_wide_{bf16,fp32}_kernel): d is
// cut into ncd = ceil(d / 64) chunks and the outputs' columns into groups
// of up to 8 chunks (512 columns); one CTA per (own row tile, group), so
// S and dP (S^T and dP^T for dK/dV) are computed once per tile pair up to
// d = 512 and once per group above it. Each output still has one writer,
// the sums have a fixed order (no atomics), and two calls give the same
// bits.
// - bf16 (mma.sync): a CTA owns 32 rows (two row blocks of 16) and has a
//   column warp for each 2 chunks of its group (up to 4: 256 threads). Warp
//   (row block, column warp) sums its part of the 16 x 32 S and dP of each
//   swept tile over its chunks of d; the partials of a row block meet in
//   shared memory, and every column warp adds them in column-warp order, so
//   all hold the same S and dP and compute P and dS in registers, the A
//   fragments of dV += P^T dO and dK += dS^T Q (or dQ += dS K) over their 2
//   chunks of the output: 128 fp32 accumulators a thread in dK/dV, 64 in
//   dQ, beside 32 of S and dP. wgmma is not used: its
//   64-row M would hold 64 keys x all of d of dK and dV (196 KB of
//   registers at d = 384) beside S^T and dP^T in one CTA, more than an SM
//   has; mma.sync's 16-row M lets a CTA own 32 rows, and its transposed
//   products read dO, Q and K with ldmatrix.trans. The own rows stay
//   resident wherever they fit beside two ring slots (up to d = 1024);
//   tiles are 128B-swizzled chunks, staged by the TMA into an mbarrier ring
//   where d is a multiple of 8 (element by element for any other d), and
//   ldmatrix reads them without
//   bank conflicts. dK/dV's accumulators take most of a thread's 255
//   registers, so one CTA of up to 256 threads runs on an SM (its up to
//   225 KB of shared memory would allow no second CTA either): 8 warps an
//   SM, as two of the 4-warp CTAs it replaces.
// - fp32 (CUDA cores, 256 threads): dK/dV owns 32 keys against 64-query
//   tiles, dQ 64 queries against 64-key tiles; each thread a block of S (or
//   S^T) and of each output chunk, 4 FMAs for each value read from shared
//   memory. d goes one chunk of the four tensors at a time, then P and dS
//   (shared memory) and the output's swept chunks of the group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using flash_mma::bf16;
using flash_mma::Dims;
using flash_mma::GridIdx;

constexpr int kFp32Threads = 128;

template <int DP>
struct Fp32Cfg {
  static constexpr int kSplit = DP <= 64 ? 2 : DP <= 128 ? 4 : 8;  // threads per row
  static constexpr int kCols = DP / kSplit;                        // columns a thread owns
  static constexpr int kRows = kFp32Threads / kSplit;  // keys (dkdv) or queries (dq) per CTA
  static constexpr int kTileQ = DP <= 64 ? 64 : DP <= 128 ? 32 : 16;  // dkdv: queries staged
  static constexpr int kTileK = DP <= 128 ? 32 : 16;                  // dq: keys staged
};

template <int DP>
struct Bf16Cfg {
  static constexpr bool kKVSmem = DP >= 128;         // dkdv: K, V fragments from smem
  static constexpr int kOutSplit = DP > 128 ? 2 : 1;  // dkdv: column slices of dK/dV
  static constexpr bool kQSmem = DP > 128;           // dq: Q, dO fragments from smem
  static constexpr size_t kDkdvSmem =
      (4 + (kKVSmem ? 2 : 0)) * Dims<DP>::kTileElems * sizeof(bf16);
  static constexpr size_t kDqSmem = (4 + (kQSmem ? 2 : 0)) * Dims<DP>::kTileElems * sizeof(bf16);
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
flash_bwd_dkdv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk,
                           int H, int d, int64_t q_sb, int64_t q_sl, int64_t k_sb,
                           int64_t k_sl, int64_t v_sb, int64_t v_sl, int64_t do_sb,
                           int64_t do_sl, float scale) {
  using C = Fp32Cfg<DP>;
  constexpr int S = C::kSplit, CT = C::kCols;
  __shared__ float qs[C::kTileQ][DP];
  __shared__ float dos[C::kTileQ][DP];
  __shared__ float lse_s[C::kTileQ];
  __shared__ float delta_s[C::kTileQ];

  const int tid = threadIdx.x;
  const int part = tid % S;
  const GridIdx g = flash_mma::grid_idx((Lk + C::kRows - 1) / C::kRows, H);
  const int key = g.tile * C::kRows + tid / S;
  const int h = g.h;
  const int64_t b = g.b;
  // keys past Lk compute on a copy of the last key and store nothing
  const int64_t krow = key < Lk ? key : Lk - 1;

  float kr[CT], vr[CT], dkr[CT], dvr[CT];
  const float* kp = k + b * k_sb + krow * k_sl + h * d;
  const float* vp = v + b * v_sb + krow * v_sl + h * d;
#pragma unroll
  for (int t = 0; t < CT; ++t) {
    const int c = S * t + part;
    kr[t] = c < d ? kp[c] : 0.f;
    vr[t] = c < d ? vp[c] : 0.f;
    dkr[t] = 0.f;
    dvr[t] = 0.f;
  }

  const float* qb = q + b * q_sb + h * d;
  const float* dob = dout + b * do_sb + h * d;
  const float* lse_b = lse + b * Lq * H + h;
  const float* delta_b = delta + b * Lq * H + h;

  for (int q0 = 0; q0 < Lq; q0 += C::kTileQ) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < C::kTileQ * DP; e += kFp32Threads) {
      const int i = e / DP;
      const int c = e - i * DP;
      const int64_t row = q0 + i;
      float qx = 0.f, dx = 0.f;
      if (row < Lq && c < d) {
        qx = qb[row * q_sl + c];
        dx = dob[row * do_sl + c];
      }
      qs[i][c] = qx;
      dos[i][c] = dx;
    }
    if (tid < C::kTileQ) {
      const int64_t row = q0 + tid;
      lse_s[tid] = row < Lq ? lse_b[row * H] : 0.f;
      delta_s[tid] = row < Lq ? delta_b[row * H] : 0.f;
    }
    __syncthreads();

    // uniform over the CTA: the shuffles below see every lane
    const int n = min(C::kTileQ, Lq - q0);
    for (int i = 0; i < n; ++i) {
      float s0 = 0.f, s1 = 0.f, dp0 = 0.f, dp1 = 0.f;
#pragma unroll
      for (int t = 0; t < CT; t += 2) {
        s0 = fmaf(qs[i][S * t + part], kr[t], s0);
        dp0 = fmaf(dos[i][S * t + part], vr[t], dp0);
        if (t + 1 < CT) {
          s1 = fmaf(qs[i][S * (t + 1) + part], kr[t + 1], s1);
          dp1 = fmaf(dos[i][S * (t + 1) + part], vr[t + 1], dp1);
        }
      }
      const float s = row_sum<S>(s0 + s1);
      const float dp = row_sum<S>(dp0 + dp1);
      const float p = expf(s * scale - lse_s[i]);
      const float ds = p * (dp - delta_s[i]);
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        dvr[t] = fmaf(p, dos[i][S * t + part], dvr[t]);
        dkr[t] = fmaf(ds, qs[i][S * t + part], dkr[t]);
      }
    }
  }

  if (key < Lk) {
    const int64_t o = (b * Lk + key) * (int64_t)H * d + h * d;
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int c = S * t + part;
      if (c < d) {
        dk[o + c] = dkr[t] * scale;
        dv[o + c] = dvr[t];
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kFp32Threads)
flash_bwd_dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int Lq, int Lk, int H, int d, int64_t q_sb,
                         int64_t q_sl, int64_t k_sb, int64_t k_sl, int64_t v_sb,
                         int64_t v_sl, int64_t do_sb, int64_t do_sl, float scale) {
  using C = Fp32Cfg<DP>;
  constexpr int S = C::kSplit, CT = C::kCols;
  __shared__ float ks[C::kTileK][DP];
  __shared__ float vs[C::kTileK][DP];

  const int tid = threadIdx.x;
  const int part = tid % S;
  const GridIdx g = flash_mma::grid_idx((Lq + C::kRows - 1) / C::kRows, H);
  const int row = g.tile * C::kRows + tid / S;
  const int h = g.h;
  const int64_t b = g.b;
  // rows past Lq compute on a copy of the last row and store nothing
  const int64_t qrow = row < Lq ? row : Lq - 1;

  float qr[CT], dor[CT], dqr[CT];
  const float* qp = q + b * q_sb + qrow * q_sl + h * d;
  const float* dop = dout + b * do_sb + qrow * do_sl + h * d;
#pragma unroll
  for (int t = 0; t < CT; ++t) {
    const int c = S * t + part;
    qr[t] = c < d ? qp[c] : 0.f;
    dor[t] = c < d ? dop[c] : 0.f;
    dqr[t] = 0.f;
  }
  const float lse_r = lse[(b * Lq + qrow) * H + h];
  const float delta_r = delta[(b * Lq + qrow) * H + h];

  const float* kb = k + b * k_sb + h * d;
  const float* vb = v + b * v_sb + h * d;

  for (int k0 = 0; k0 < Lk; k0 += C::kTileK) {
    __syncthreads();
    for (int e = tid; e < C::kTileK * DP; e += kFp32Threads) {
      const int j = e / DP;
      const int c = e - j * DP;
      const int64_t kk = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kk < Lk && c < d) {
        kx = kb[kk * k_sl + c];
        vx = vb[kk * v_sl + c];
      }
      ks[j][c] = kx;
      vs[j][c] = vx;
    }
    __syncthreads();

    const int n = min(C::kTileK, Lk - k0);
    for (int j = 0; j < n; ++j) {
      float s0 = 0.f, s1 = 0.f, dp0 = 0.f, dp1 = 0.f;
#pragma unroll
      for (int t = 0; t < CT; t += 2) {
        s0 = fmaf(qr[t], ks[j][S * t + part], s0);
        dp0 = fmaf(dor[t], vs[j][S * t + part], dp0);
        if (t + 1 < CT) {
          s1 = fmaf(qr[t + 1], ks[j][S * (t + 1) + part], s1);
          dp1 = fmaf(dor[t + 1], vs[j][S * (t + 1) + part], dp1);
        }
      }
      const float s = row_sum<S>(s0 + s1);
      const float dp = row_sum<S>(dp0 + dp1);
      const float ds = expf(s * scale - lse_r) * (dp - delta_r);
#pragma unroll
      for (int t = 0; t < CT; ++t) dqr[t] = fmaf(ds, ks[j][S * t + part], dqr[t]);
    }
  }

  if (row < Lq) {
    float* dqp = dq + (b * Lq + row) * (int64_t)H * d + h * d;
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int c = S * t + part;
      if (c < d) dqp[c] = dqr[t] * scale;
    }
  }
}

// lse and delta of a 64-row query tile into shared memory (4-byte cp.async,
// zero-filled past Lq): threads 0-63 copy lse, 64-127 delta.
__device__ __forceinline__ void load_rows_stats(float* lse_s, float* delta_s,
                                                const float* lse_b, const float* delta_b,
                                                int H, int q0, int Lq) {
  const int t = threadIdx.x & (flash_mma::kTile - 1);
  const bool ok = q0 + t < Lq;
  const int64_t off = static_cast<int64_t>(ok ? q0 + t : 0) * H;
  if (threadIdx.x < flash_mma::kTile)
    flash_mma::cp_async4(flash_mma::smem_addr(lse_s + t), lse_b + off, ok);
  else
    flash_mma::cp_async4(flash_mma::smem_addr(delta_s + t), delta_b + off, ok);
}

template <int DP>
__global__ void __launch_bounds__(flash_mma::kThreads)
flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int Lq, int Lk,
                           int H, int d, int64_t q_sb, int64_t q_sl, int64_t k_sb,
                           int64_t k_sl, int64_t v_sb, int64_t v_sl, int64_t do_sb,
                           int64_t do_sl, float scale) {
  using namespace flash_mma;
  using P = Dims<DP>;
  using C = Bf16Cfg<DP>;
  constexpr int kNOut = P::kN8 / C::kOutSplit;  // n8 tiles of dK/dV columns a CTA owns
  // Q stages 0-1, then dO stages 0-1. The CTA's K and V tiles ride in stage
  // 1 until their fragments are in registers, or, from DP = 128, have tiles
  // of their own for the whole sweep.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ __align__(16) float lse_s[2][kTile];
  __shared__ __align__(16) float delta_s[2][kTile];
  bf16* const qs[2] = {smem, smem + P::kTileElems};
  bf16* const dos[2] = {smem + 2 * P::kTileElems, smem + 3 * P::kTileElems};
  bf16* const kt = C::kKVSmem ? smem + 4 * P::kTileElems : qs[1];
  bf16* const vt = C::kKVSmem ? smem + 5 * P::kTileElems : dos[1];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const GridIdx g = grid_idx((Lk + kTile - 1) / kTile * C::kOutSplit, H);
  const int k0 = g.tile / C::kOutSplit * kTile;
  const int c0 = g.tile % C::kOutSplit * kNOut * 8;  // first dK/dV column of this CTA
  const int h = g.h;
  const int64_t b = g.b;
  const bf16* qb = q + b * q_sb + h * d;
  const bf16* dob = dout + b * do_sb + h * d;
  const float* lse_b = lse + b * Lq * H + h;
  const float* delta_b = delta + b * Lq * H + h;

  zero_pad_columns<DP>(smem, (C::kKVSmem ? 6 : 4) * kTile, d);
  load_tile<DP>(kt, k + b * k_sb + k0 * k_sl + h * d, k_sl, min(kTile, Lk - k0), d);
  load_tile<DP>(vt, v + b * v_sb + k0 * v_sl + h * d, v_sl, min(kTile, Lk - k0), d);
  load_tile<DP>(qs[0], qb, q_sl, min(kTile, Lq), d);
  load_tile<DP>(dos[0], dob, do_sl, min(kTile, Lq), d);
  load_rows_stats(lse_s[0], delta_s[0], lse_b, delta_b, H, 0, Lq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[C::kKVSmem ? 1 : P::kK16][4], vf[C::kKVSmem ? 1 : P::kK16][4];
  if constexpr (!C::kKVSmem) {
    load_a<DP>(kf, kt, warp * 16);
    load_a<DP>(vf, vt, warp * 16);
    __syncthreads();  // every warp holds its K and V before stage 1 is overwritten
  }

  const float sl2 = scale * kLog2e;
  float dka[kNOut][4] = {}, dva[kNOut][4] = {};
  const int ntiles = (Lq + kTile - 1) / kTile;
  for (int n = 0; n < ntiles; ++n) {
    const int st = n & 1;
    if (n + 1 < ntiles) {
      const int q1 = (n + 1) * kTile;
      load_tile<DP>(qs[st ^ 1], qb + q1 * q_sl, q_sl, min(kTile, Lq - q1), d);
      load_tile<DP>(dos[st ^ 1], dob + q1 * do_sl, do_sl, min(kTile, Lq - q1), d);
      load_rows_stats(lse_s[st ^ 1], delta_s[st ^ 1], lse_b, delta_b, H, q1, Lq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int qbase = n * kTile;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // 16 query columns at a time
      if (qbase + 16 * j >= Lq) break;  // uniform: the rest of the tile is past Lq
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 16 queries
      float s[2][4] = {}, dp[2][4] = {};
      if constexpr (C::kKVSmem) {
        mma_abt_s<DP>(s[0], s[1], kt, warp * 16, qs[st], 16 * j);
        mma_abt_s<DP>(dp[0], dp[1], vt, warp * 16, dos[st], 16 * j);
      } else {
        mma_abt<DP>(s[0], s[1], kf, qs[st], 16 * j);
        mma_abt<DP>(dp[0], dp[1], vf, dos[st], 16 * j);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 16 * j + nt * 8 + 2 * (lane & 3) + (i & 1);  // query in the tile
          // query rows >= Lq: P = 0, as lse = +inf would give
          const float p = qbase + c < Lq
                              ? ex2(fmaf(s[nt][i], sl2, -lse_s[st][c] * kLog2e))
                              : 0.f;
          s[nt][i] = p;
          dp[nt][i] = p * (dp[nt][i] - delta_s[st][c]);
        }
      uint32_t pa[4], dsa[4];
      acc_to_a(pa, s[0], s[1]);
      acc_to_a(dsa, dp[0], dp[1]);
      mma_at<DP, kNOut>(dva, pa, dos[st], 16 * j, c0);   // dV += P^T dO
      mma_at<DP, kNOut>(dka, dsa, qs[st], 16 * j, c0);   // dK += dS^T Q
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  const int64_t ld = static_cast<int64_t>(H) * d;
  const int64_t off = b * Lk * ld + h * d;
  store_rows<kNOut>(dk + off, ld, k0 + warp * 16, Lk, dka, scale, scale, d, c0);
  store_rows<kNOut>(dv + off, ld, k0 + warp * 16, Lk, dva, 1.f, 1.f, d, c0);
}

template <int DP>
__global__ void __launch_bounds__(flash_mma::kThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int Lq, int Lk, int H, int d,
                         int64_t q_sb, int64_t q_sl, int64_t k_sb, int64_t k_sl,
                         int64_t v_sb, int64_t v_sl, int64_t do_sb, int64_t do_sl,
                         float scale) {
  using namespace flash_mma;
  using P = Dims<DP>;
  using C = Bf16Cfg<DP>;
  // K stages 0-1, then V stages 0-1. The CTA's Q and dO tiles ride in stage
  // 1 until their fragments are in registers, or, at DP = 256, have tiles
  // of their own for the whole sweep.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* const ks[2] = {smem, smem + P::kTileElems};
  bf16* const vs[2] = {smem + 2 * P::kTileElems, smem + 3 * P::kTileElems};
  bf16* const qt = C::kQSmem ? smem + 4 * P::kTileElems : ks[1];
  bf16* const dt = C::kQSmem ? smem + 5 * P::kTileElems : vs[1];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const GridIdx g = grid_idx((Lq + kTile - 1) / kTile, H);
  const int q0 = g.tile * kTile;
  const int h = g.h;
  const int64_t b = g.b;
  const bf16* kb = k + b * k_sb + h * d;
  const bf16* vb = v + b * v_sb + h * d;

  zero_pad_columns<DP>(smem, (C::kQSmem ? 6 : 4) * kTile, d);
  load_tile<DP>(qt, q + b * q_sb + q0 * q_sl + h * d, q_sl, min(kTile, Lq - q0), d);
  load_tile<DP>(dt, dout + b * do_sb + q0 * do_sl + h * d, do_sl, min(kTile, Lq - q0), d);
  load_tile<DP>(ks[0], kb, k_sl, min(kTile, Lk), d);
  load_tile<DP>(vs[0], vb, v_sl, min(kTile, Lk), d);
  cp_async_commit();

  // lse (base 2) and delta of rows g and g+8 of this warp; rows past Lq
  // read the last row and store nothing
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = min(q0 + warp * 16 + (lane >> 2) + 8 * r, Lq - 1);
    lse2[r] = lse[(b * Lq + row) * H + h] * kLog2e;
    dl[r] = delta[(b * Lq + row) * H + h];
  }
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[C::kQSmem ? 1 : P::kK16][4], df[C::kQSmem ? 1 : P::kK16][4];
  if constexpr (!C::kQSmem) {
    load_a<DP>(qf, qt, warp * 16);
    load_a<DP>(df, dt, warp * 16);
    __syncthreads();  // every warp holds its Q and dO before stage 1 is overwritten
  }

  const float sl2 = scale * kLog2e;
  float dqa[P::kN8][4] = {};
  const int ntiles = (Lk + kTile - 1) / kTile;
  for (int n = 0; n < ntiles; ++n) {
    const int st = n & 1;
    if (n + 1 < ntiles) {
      const int k1 = (n + 1) * kTile;
      load_tile<DP>(ks[st ^ 1], kb + k1 * k_sl, k_sl, min(kTile, Lk - k1), d);
      load_tile<DP>(vs[st ^ 1], vb + k1 * v_sl, v_sl, min(kTile, Lk - k1), d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int kbase = n * kTile;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // 16 keys at a time
      if (kbase + 16 * j >= Lk) break;  // uniform: the rest of the tile is past Lk
      float s[2][4] = {}, dp[2][4] = {};
      if constexpr (C::kQSmem) {
        mma_abt_s<DP>(s[0], s[1], qt, warp * 16, ks[st], 16 * j);   // S = Q K^T
        mma_abt_s<DP>(dp[0], dp[1], dt, warp * 16, vs[st], 16 * j);  // dP = dO V^T
      } else {
        mma_abt<DP>(s[0], s[1], qf, ks[st], 16 * j);
        mma_abt<DP>(dp[0], dp[1], df, vs[st], 16 * j);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = kbase + 16 * j + nt * 8 + 2 * (lane & 3) + (i & 1);
          // keys >= Lk: P = 0, as S = -inf would give
          const float p = key < Lk ? ex2(fmaf(s[nt][i], sl2, -lse2[i >> 1])) : 0.f;
          dp[nt][i] = p * (dp[nt][i] - dl[i >> 1]);
        }
      uint32_t dsa[4];
      acc_to_a(dsa, dp[0], dp[1]);
      mma_at<DP, P::kN8>(dqa, dsa, ks[st], 16 * j);  // dQ += dS K
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  const int64_t ld = static_cast<int64_t>(H) * d;
  store_rows<P::kN8>(dq + b * Lq * ld + h * d, ld, q0 + warp * 16, Lq, dqa, scale, scale, d);
}

// ---------------------------------------------------------------------------
// Wide heads, d > 256 (flash_mma.cuh, "Wide heads"): a CTA per (32-row tile
// of its own rows, column group of up to 512 columns); S and dP (or their
// transposes) summed over all of d once per tile pair.

constexpr int kWideRows = 32;  // own rows of a CTA (keys for dK/dV, queries for dQ)
constexpr int kWideSwept = 32;  // rows of a swept tile
constexpr int kWideMaxThreads = 256;
constexpr int kWideChunk = kWideRows * flash_mma::kChunkRowBytes;  // one staged chunk, 4 KB
// the fp32 kernels: threads, own rows of dK/dV and of dQ, swept rows
constexpr int kF32Threads = 256;
constexpr int kF32KeyRows = 32;
constexpr int kF32QueryRows = 64;
constexpr int kF32Swept = 64;

struct WideArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  bf16 *dq, *dk, *dv;
  int Lq, Lk, H, d;
  int64_t q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, do_sb, do_sl;
  float scale;
  int mode;  // flash_mma::WideStaging
  flash_mma::WidePlan p;
};

// The column warps of a bf16 wide CTA: each owns up to 2 chunks of the
// group (dK and dV, or dQ: 16 rows x 128 columns in registers); a CTA has 2
// row blocks of 16 rows x nw column warps.
__host__ __device__ inline int wide_column_warps(int gchunks) { return (gchunks + 1) / 2; }

// Both bf16 kernels, mma.sync: warp (rb = warp % 2, j = warp / 2) owns the
// group's output chunks j and j + nw for its 16 own rows and sums its part
// of the 16 x 32 S and dP of each swept tile, the chunks i = j, j + nw, ...
// of each S step. The nw partials of a row block meet in shared memory (x,
// thread-major) and every column warp adds them in the same order (0 ..
// nw - 1), so all hold the same S and dP bit for bit and compute P and dS
// themselves, in registers, as the A fragments of the output products.
// Their B operands (dO, Q or K) are the swept tile's chunks, read
// transposed by ldmatrix.trans from the swizzled tiles. wgmma is not used
// here: its 64-row M would put 64 own rows x 128 columns of dK and dV (128
// fp32 a thread) beside 64 x 32 of S and dP in a warpgroup, which at d = 384
// needs 3 warpgroups of over 200 registers for one 64-key tile, more than
// an SM's registers; mma.sync's 16-row M lets a CTA own 32 rows.
template <bool kDkdv>
__device__ __forceinline__ void wide_bwd_bf16(const CUtensorMap* const (&maps)[4],
                                              const WideArgs& a) {
  using namespace flash_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[kMaxStages + 1];  // ring slots, then the own rows
  __shared__ float stats[2 * kWideSwept];  // dK/dV: the swept tile's lse (base 2), delta
  const WidePlan& p = a.p;
  unsigned char* const base = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* const own = base;  // resident own rows: chunk c of the two at 2c, 2c + 1
  unsigned char* const ring = base + p.own_bytes;
  float* const x = reinterpret_cast<float*>(ring + p.stages * p.slot_bytes);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nw = nthreads >> 6, rb = warp & 1, j = warp >> 1;
  // own rows (kDkdv: keys, K and V; else queries, Q and dO) and swept rows
  const int Lown = kDkdv ? a.Lk : a.Lq, Lsw = kDkdv ? a.Lq : a.Lk;
  const GridIdx gi = grid_idx((Lown + kWideRows - 1) / kWideRows * p.groups, a.H);
  const int grp = gi.tile % p.groups, r0 = gi.tile / p.groups * kWideRows;
  const int h = gi.h;
  const int64_t b = gi.b;
  const int cg0 = grp * p.gchunks, ncg = min(p.gchunks, p.ncd - cg0);
  const int orows = min(kWideRows, Lown - r0);
  // the four tensors by role: own 0, own 1, swept 0, swept 1, with their
  // maps, head bases and row pitches
  const CUtensorMap* const mp[4] = {maps[kDkdv ? 1 : 0], maps[kDkdv ? 2 : 3],
                                    maps[kDkdv ? 0 : 1], maps[kDkdv ? 3 : 2]};
  const bf16* const src0 = kDkdv ? a.k + b * a.k_sb + h * a.d : a.q + b * a.q_sb + h * a.d;
  const bf16* const src1 = kDkdv ? a.v + b * a.v_sb + h * a.d : a.dout + b * a.do_sb + h * a.d;
  const bf16* const src2 = kDkdv ? a.q + b * a.q_sb + h * a.d : a.k + b * a.k_sb + h * a.d;
  const bf16* const src3 = kDkdv ? a.dout + b * a.do_sb + h * a.d : a.v + b * a.v_sb + h * a.d;
  const int64_t ld0 = kDkdv ? a.k_sl : a.q_sl, ld1 = kDkdv ? a.v_sl : a.do_sl;
  const int64_t ld2 = kDkdv ? a.q_sl : a.k_sl, ld3 = kDkdv ? a.do_sl : a.v_sl;
  // the output's swept tensors (dK/dV: Q and dO; dQ: K), at nout a chunk
  constexpr int nout = kDkdv ? 2 : 1;
  const bool fused = p.osteps == 0;  // the S step's swept chunks serve the output
  const int per = p.ssteps + p.osteps;
  const int steps = (Lsw + kWideSwept - 1) / kWideSwept * per;

  // the role's head row `row`, pitch, rows and columns of chunk c
  auto tile = [&](int role, int c) {
    const int row = role < 2 ? r0 : 0;
    const bf16* const base = role == 0 ? src0 : role == 1 ? src1 : role == 2 ? src2 : src3;
    const int64_t pitch = role == 0 ? ld0 : role == 1 ? ld1 : role == 2 ? ld2 : ld3;
    return TileSrc{base + row * pitch + c * kWideCols, pitch, role < 2 ? orows : Lsw,
                   min(kWideCols, a.d - c * kWideCols)};
  };
  // issue step i: S step s stages the swept rows' chunks s cps .. of d,
  // chunk c at 2c, 2c + 1 (and the own rows' where they are not resident:
  // the four at 4c ..); output step o the group's chunks o ocps .. of the
  // output's swept tensors, at nout c ..; by the TMA (one thread), or by
  // every thread element by element
  auto issue = [&](int i) {
    const int slot = i % p.stages;
    unsigned char* const dst = ring + slot * p.slot_bytes;
    uint64_t* const bar = &bars[slot];
    const int n = i / per, s = i - n * per;
    const int s0 = n * kWideSwept;
    const bool ostep = s >= p.ssteps;
    const int c0 = ostep ? cg0 + (s - p.ssteps) * p.ocps : s * p.cps;
    const int cn = ostep ? min(p.ocps, cg0 + ncg - c0) : min(p.cps, p.ncd - c0);
    const int pc = ostep ? nout : p.resident ? 2 : 4;  // tiles a chunk
    // tile t of the step: chunk c0 + t / pc in the role below
    auto role = [&](int t) {
      const int r = t % pc;
      return ostep ? 2 + (kDkdv ? r : 0) : pc == 2 ? 2 + r : r;
    };
    auto info = [&](int t) {
      const int rl = role(t);
      TileSrc ts = tile(rl, c0 + t / pc);
      if (rl >= 2) {  // the swept rows of this tile
        ts.src += s0 * ts.ld;
        ts.valid = min(kWideSwept, Lsw - s0);
      }
      return ts;
    };
    if (a.mode == kStageElements) {
      stage_tiles<8>(dst, pc * cn, 5, info);
      return;
    }
    if (tid != 0) return;
    mbar_expect(bar, pc * cn * kWideChunk);
    for (int t = 0; t < pc * cn; ++t) {
      const int rl = role(t);
      tma_chunk(dst + t * kWideChunk, mp[rl], bar, (c0 + t / pc) * kWideCols, h,
                rl < 2 ? r0 : s0, static_cast<int>(b));
    }
  };

  if (tid == 0) {
    for (int s = 0; s <= kMaxStages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto oinfo = [&](int t) { return tile(t & 1, t >> 1); };
  if (p.resident && a.mode == kStageElements) {
    stage_tiles<8>(own, 2 * p.ncd, 5, oinfo);
  } else if (p.resident && tid == 0) {
    mbar_expect(&bars[kMaxStages], 2 * p.ncd * kWideChunk);
    for (int t = 0; t < 2 * p.ncd; ++t)
      tma_chunk(own + t * kWideChunk, mp[t & 1], &bars[kMaxStages], (t >> 1) * kWideCols, h,
                r0, static_cast<int>(b));
  }
  for (int i = 0; i < p.stages && i < steps; ++i) issue(i);
  if (a.mode == kStageElements)
    __syncthreads();
  else if (a.mode == kStageTma && p.resident)
    mbar_wait(&bars[kMaxStages], 0);

  // dQ: lse (base 2) and delta of this lane's rows g and g + 8 (rows past
  // Lq read the last row and store nothing)
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if (!kDkdv) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = min(r0 + 16 * rb + (lane >> 2) + 8 * r, a.Lq - 1);
      lse2[r] = a.lse[(b * a.Lq + row) * a.H + h] * kLog2e;
      dl[r] = a.delta[(b * a.Lq + row) * a.H + h];
    }
  }
  const float sl2 = a.scale * kLog2e;
  float acc0[2][8][4] = {};  // dK (dkdv) or dQ, of group chunks j and j + nw
  float acc1[2][8][4] = {};  // dV (dkdv)
  float s[4][4], dp[4][4];
  uint32_t pa[2][4], dsa[2][4];  // P and dS as the A fragments of 2 k16 steps
  float* const mine = x + (rb * nw + j) * 32 * 32;
  for (int i = 0; i < steps; ++i) {
    const int slot = i % p.stages;
    unsigned char* const cur = ring + slot * p.slot_bytes;
    if (a.mode == kStageTma) mbar_wait(&bars[slot], (i / p.stages) & 1);
    const int n = i / per, st = i - n * per;
    const int s0 = n * kWideSwept;
    // dK/dV: lse (base 2) and delta of the swept tile's queries (the
    // columns of S^T), loaded by 64 threads at its first step and stored
    // after the products, for the step that computes P
    float stat = 0.f;
    const bool stat_lane = kDkdv && st == 0 && tid < 2 * kWideSwept;
    if (stat_lane) {
      const int q = s0 + (tid & (kWideSwept - 1));
      if (q < a.Lq) {
        const int64_t at = (b * a.Lq + q) * a.H + h;
        stat = tid < kWideSwept ? a.lse[at] * kLog2e : a.delta[at];
      }
    }
    if (st < p.ssteps) {
      // this warp's part of S (S^T) and dP (dP^T): 16 own rows x 32 swept
      if (st == 0) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
      }
      const int c0 = st * p.cps, cn = min(p.cps, p.ncd - c0);
      for (int c = j; c < cn; c += nw) {
        const unsigned char* const ot = p.resident ? own + 2 * (c0 + c) * kWideChunk
                                                   : cur + 4 * c * kWideChunk;
        const unsigned char* const sw = cur + (p.resident ? 2 * c : 4 * c + 2) * kWideChunk;
        chunk_abt<4>(s, smem_addr(ot), 16 * rb, smem_addr(sw), 0);
        chunk_abt<4>(dp, smem_addr(ot + kWideChunk), 16 * rb, smem_addr(sw + kWideChunk), 0);
      }
      if (st == p.ssteps - 1) {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          mine[e * 32 + lane] = s[e >> 2][e & 3];
          mine[(16 + e) * 32 + lane] = dp[e >> 2][e & 3];
        }
      }
    }
    if (stat_lane) stats[tid] = stat;
    if (fused) __syncthreads();  // the partials are in
    if (fused || st == p.ssteps) {
      // S and dP: the row block's partials summed in column-warp order
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
      for (int w = 0; w < nw; ++w) {
        const float* const xs = x + (rb * nw + w) * 32 * 32;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          s[e >> 2][e & 3] += xs[e * 32 + lane];
          dp[e >> 2][e & 3] += xs[(16 + e) * 32 + lane];
        }
      }
      // P = exp(S scale - lse) and dS = P (dP - delta), 0 past the swept
      // rows' end
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = s0 + 8 * t + 2 * (lane & 3) + (e & 1);
          float pr = 0.f, dd = 0.f;
          if (col < Lsw) {
            const int c = col - s0;
            pr = ex2(fmaf(s[t][e], sl2, kDkdv ? -stats[c] : -lse2[e >> 1]));
            dd = kDkdv ? stats[kWideSwept + c] : dl[e >> 1];
          }
          s[t][e] = pr;
          dp[t][e] = pr * (dp[t][e] - dd);
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        acc_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
        acc_to_a(dsa[kk], dp[2 * kk], dp[2 * kk + 1]);
      }
    }
    if (fused || st >= p.ssteps) {
      // the output products over this warp's chunks among the step's
      const int g0 = fused ? 0 : (st - p.ssteps) * p.ocps;
      const int gn = fused ? ncg : min(p.ocps, ncg - g0);
#pragma unroll
      for (int oc = 0; oc < 2; ++oc) {
        const int g = j + oc * nw - g0;  // the chunk's place in the step
        if (g < 0 || g >= gn) continue;
        const unsigned char* const t0 = cur + (fused ? 2 * g : nout * g) * kWideChunk;
        if (kDkdv) {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            chunk_at(acc1[oc], pa[kk], smem_addr(t0 + kWideChunk), 16 * kk);  // dV += P^T dO
            chunk_at(acc0[oc], dsa[kk], smem_addr(t0), 16 * kk);              // dK += dS^T Q
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            chunk_at(acc0[oc], dsa[kk], smem_addr(t0), 16 * kk);  // dQ += dS K
        }
      }
    }
    __syncthreads();  // every warp is done with this slot (and with x)
    if (i + p.stages < steps) {
      issue(i + p.stages);
      if (a.mode == kStageElements) __syncthreads();
    }
  }

  const int64_t ldo = static_cast<int64_t>(a.H) * a.d;
  const int row0 = r0 + 16 * rb;
#pragma unroll
  for (int oc = 0; oc < 2; ++oc) {
    if (j + oc * nw >= ncg) continue;
    const int col = (cg0 + j + oc * nw) * kWideCols;
    if (kDkdv) {
      const int64_t off = b * a.Lk * ldo + h * a.d;
      store_rows<8>(a.dk + off, ldo, row0, a.Lk, acc0[oc], a.scale, a.scale, a.d, col);
      store_rows<8>(a.dv + off, ldo, row0, a.Lk, acc1[oc], 1.f, 1.f, a.d, col);
    } else {
      store_rows<8>(a.dq + b * a.Lq * ldo + h * a.d, ldo, row0, a.Lq, acc0[oc], a.scale,
                    a.scale, a.d, col);
    }
  }
}

// maps: q, k, v, dout (wide_map, boxes of 32 rows)
__global__ void __launch_bounds__(kWideMaxThreads, 1)
flash_bwd_dkdv_wide_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap do_map, const WideArgs a) {
  const CUtensorMap* const maps[4] = {&q_map, &k_map, &v_map, &do_map};
  wide_bwd_bf16<true>(maps, a);
}

__global__ void __launch_bounds__(kWideMaxThreads, 1)
flash_bwd_dq_wide_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap do_map, const WideArgs a) {
  const CUtensorMap* const maps[4] = {&q_map, &k_map, &v_map, &do_map};
  wide_bwd_bf16<false>(maps, a);
}

// fp32 dK/dV: 32 keys a CTA, 64-query tiles, on the CUDA cores. Thread
// (warp, lane) owns keys 4 warp + lane / 16 + 2 i (i < 2) and queries (and
// output columns) lane % 16 + 16 j (j < 4): 8 values of S^T and dP^T, and 8
// of dK and dV in each chunk of the group, so each value read from shared
// memory feeds 2 or 4 FMAs. d goes one chunk at a time (K, V, Q and dO's
// chunk staged together); S^T and dP^T are summed over every chunk once
// per query tile, P^T and dS^T go to shared memory, and Q's and dO's chunks
// of the group come in turn for dV += P^T dO and dK += dS^T Q. dP^T is
// summed a chunk at a time and the chunks' sums added: dS^T = P^T (dP^T -
// D) cancels where the gradient is small (to zero over a single key), and
// one running sum over a thousand columns rounds several times as far.
__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dkdv_wide_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk,
                                int H, int d, int64_t q_sb, int64_t q_sl, int64_t k_sb,
                                int64_t k_sl, int64_t v_sb, int64_t v_sl, int64_t do_sb,
                                int64_t do_sl, float scale) {
  using namespace flash_mma;
  extern __shared__ float fsm[];
  float* const ks = fsm;                             // K's chunk, then P^T
  float* const vs = ks + kF32KeyRows * kF32Pitch;        // V's chunk, then dS^T
  float* const qs = vs + kF32KeyRows * kF32Pitch;        // Q's chunk
  float* const dos = qs + kF32Swept * kF32Pitch;         // dO's chunk
  float* const lse_s = dos + kF32Swept * kF32Pitch;      // the query tile's lse
  float* const delta_s = lse_s + kF32Swept;           // and delta

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qq = lane & 15, kr = 4 * warp + (lane >> 4);  // keys kr + 2 i, queries qq + 16 j
  const int ncd = wide_chunks(d), groups = wide_groups(d);
  const int gchunks = (ncd + groups - 1) / groups;
  const GridIdx gi = grid_idx((Lk + kF32KeyRows - 1) / kF32KeyRows * groups, H);
  const int grp = gi.tile % groups, k0 = gi.tile / groups * kF32KeyRows;
  const int h = gi.h;
  const int64_t b = gi.b;
  const int cg0 = grp * gchunks, ncg = min(gchunks, ncd - cg0);
  const int krows = min(kF32KeyRows, Lk - k0);
  const float* const kb = k + b * k_sb + k0 * k_sl + h * d;
  const float* const vb = v + b * v_sb + k0 * v_sl + h * d;
  const float* const qb = q + b * q_sb + h * d;
  const float* const dob = dout + b * do_sb + h * d;

  float dka[kGroupChunks][2][4] = {}, dva[kGroupChunks][2][4] = {};
  for (int q0 = 0; q0 < Lq; q0 += kF32Swept) {
    const int qrows = min(kF32Swept, Lq - q0);
    float s[2][4] = {}, dp[2][4] = {};
    for (int c = 0; c < ncd; ++c) {
      const int cols = min(kWideCols, d - c * kWideCols);
      __syncthreads();  // every thread is done with the tiles
      stage_f32(ks, kb + c * kWideCols, k_sl, kF32KeyRows, krows, cols);
      stage_f32(vs, vb + c * kWideCols, v_sl, kF32KeyRows, krows, cols);
      stage_f32(qs, qb + q0 * q_sl + c * kWideCols, q_sl, kF32Swept, qrows, cols);
      stage_f32(dos, dob + q0 * do_sl + c * kWideCols, do_sl, kF32Swept, qrows, cols);
      if (c == 0 && threadIdx.x < kF32Swept) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < Lq ? lse[(b * Lq + row) * H + h] : 0.f;
        delta_s[threadIdx.x] = row < Lq ? delta[(b * Lq + row) * H + h] : 0.f;
      }
      __syncthreads();
      float dpc[2][4] = {};  // this chunk's part of dP^T (kept apart: see below)
#pragma unroll 4
      for (int t = 0; t < kWideCols; ++t) {
        float kv[2], vv[2], qv[4], dv4[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          kv[i] = ks[(kr + 2 * i) * kF32Pitch + t];
          vv[i] = vs[(kr + 2 * i) * kF32Pitch + t];
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          qv[jj] = qs[(qq + 16 * jj) * kF32Pitch + t];
          dv4[jj] = dos[(qq + 16 * jj) * kF32Pitch + t];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            s[i][jj] = fmaf(kv[i], qv[jj], s[i][jj]);
            dpc[i][jj] = fmaf(vv[i], dv4[jj], dpc[i][jj]);
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) dp[i][jj] += dpc[i][jj];
    }
    __syncthreads();  // every thread is done with K's and V's chunks
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = qq + 16 * jj;
        const float p = q0 + col < Lq ? expf(s[i][jj] * scale - lse_s[col]) : 0.f;
        ks[(kr + 2 * i) * kF32Pitch + col] = p;
        vs[(kr + 2 * i) * kF32Pitch + col] = p * (dp[i][jj] - delta_s[col]);
      }
#pragma unroll
    for (int oc = 0; oc < kGroupChunks; ++oc) {
      if (oc >= ncg) break;
      const int c = cg0 + oc, cols = min(kWideCols, d - c * kWideCols);
      __syncthreads();  // P^T and dS^T are in; every thread is done with the last chunks
      stage_f32(qs, qb + q0 * q_sl + c * kWideCols, q_sl, kF32Swept, qrows, cols);
      stage_f32(dos, dob + q0 * do_sl + c * kWideCols, do_sl, kF32Swept, qrows, cols);
      __syncthreads();
#pragma unroll 4
      for (int t = 0; t < kF32Swept; ++t) {
        float pv[2], dsv[2], qv[4], dv4[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pv[i] = ks[(kr + 2 * i) * kF32Pitch + t];
          dsv[i] = vs[(kr + 2 * i) * kF32Pitch + t];
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          qv[jj] = qs[t * kF32Pitch + qq + 16 * jj];
          dv4[jj] = dos[t * kF32Pitch + qq + 16 * jj];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            dva[oc][i][jj] = fmaf(pv[i], dv4[jj], dva[oc][i][jj]);
            dka[oc][i][jj] = fmaf(dsv[i], qv[jj], dka[oc][i][jj]);
          }
      }
    }
  }

  const int64_t ld = static_cast<int64_t>(H) * d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kr + 2 * i;
    if (key >= Lk) continue;
    const int64_t o = (b * Lk + key) * ld + h * d;
#pragma unroll
    for (int oc = 0; oc < kGroupChunks; ++oc) {
      if (oc >= ncg) break;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = (cg0 + oc) * kWideCols + qq + 16 * jj;
        if (col < d) {
          dk[o + col] = dka[oc][i][jj] * scale;
          dv[o + col] = dva[oc][i][jj];
        }
      }
    }
  }
}

// fp32 dQ: 64 query rows a CTA, 64-key tiles, as K1's fp32 kernel: thread
// (warp, lane) owns rows 8 warp + lane / 16 + 2 i and keys (and output
// columns) lane % 16 + 16 j (i, j < 4). S and dP are summed over every
// chunk of d (Q, dO, K and V's chunk staged together) once per key tile, dS
// goes to shared memory, and K's chunks of the group come in turn for
// dQ += dS K.
__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dq_wide_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dq, int Lq, int Lk, int H, int d,
                              int64_t q_sb, int64_t q_sl, int64_t k_sb, int64_t k_sl,
                              int64_t v_sb, int64_t v_sl, int64_t do_sb, int64_t do_sl,
                              float scale) {
  using namespace flash_mma;
  extern __shared__ float fsm[];
  float* const qs = fsm;                           // Q's chunk, then dS
  float* const dos = qs + kF32QueryRows * kF32Pitch;  // dO's chunk
  float* const ks = dos + kF32QueryRows * kF32Pitch;  // K's chunk
  float* const vs = ks + kF32Swept * kF32Pitch;       // V's chunk

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kq = lane & 15, r0 = 8 * warp + (lane >> 4);  // rows r0 + 2 i, keys kq + 16 j
  const int ncd = wide_chunks(d), groups = wide_groups(d);
  const int gchunks = (ncd + groups - 1) / groups;
  const GridIdx gi = grid_idx((Lq + kF32QueryRows - 1) / kF32QueryRows * groups, H);
  const int grp = gi.tile % groups, q0 = gi.tile / groups * kF32QueryRows;
  const int h = gi.h;
  const int64_t b = gi.b;
  const int cg0 = grp * gchunks, ncg = min(gchunks, ncd - cg0);
  const int qrows = min(kF32QueryRows, Lq - q0);
  const float* const qb = q + b * q_sb + q0 * q_sl + h * d;
  const float* const dob = dout + b * do_sb + q0 * do_sl + h * d;
  const float* const kb = k + b * k_sb + h * d;
  const float* const vb = v + b * v_sb + h * d;
  // lse and delta of this thread's rows (rows past Lq read the last row and
  // store nothing)
  float lse_r[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = min(q0 + r0 + 2 * i, Lq - 1);
    lse_r[i] = lse[(b * Lq + row) * H + h];
    dl[i] = delta[(b * Lq + row) * H + h];
  }

  float dqa[kGroupChunks][4][4] = {};
  for (int k0 = 0; k0 < Lk; k0 += kF32Swept) {
    const int krows = min(kF32Swept, Lk - k0);
    float s[4][4] = {}, dp[4][4] = {};
    for (int c = 0; c < ncd; ++c) {
      const int cols = min(kWideCols, d - c * kWideCols);
      __syncthreads();  // every thread is done with the tiles
      stage_f32(qs, qb + c * kWideCols, q_sl, kF32QueryRows, qrows, cols);
      stage_f32(dos, dob + c * kWideCols, do_sl, kF32QueryRows, qrows, cols);
      stage_f32(ks, kb + k0 * k_sl + c * kWideCols, k_sl, kF32Swept, krows, cols);
      stage_f32(vs, vb + k0 * v_sl + c * kWideCols, v_sl, kF32Swept, krows, cols);
      __syncthreads();
      float dpc[4][4] = {};  // this chunk's part of dP (kept apart: see above)
#pragma unroll 2
      for (int t = 0; t < kWideCols; ++t) {
        float qv[4], dv4[4], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = qs[(r0 + 2 * i) * kF32Pitch + t];
          dv4[i] = dos[(r0 + 2 * i) * kF32Pitch + t];
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          kv[jj] = ks[(kq + 16 * jj) * kF32Pitch + t];
          vv[jj] = vs[(kq + 16 * jj) * kF32Pitch + t];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
            dpc[i][jj] = fmaf(dv4[i], vv[jj], dpc[i][jj]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) dp[i][jj] += dpc[i][jj];
    }
    __syncthreads();  // every thread is done with Q's chunk
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = kq + 16 * jj;
        const float p = k0 + col < Lk ? expf(s[i][jj] * scale - lse_r[i]) : 0.f;
        qs[(r0 + 2 * i) * kF32Pitch + col] = p * (dp[i][jj] - dl[i]);
      }
#pragma unroll
    for (int oc = 0; oc < kGroupChunks; ++oc) {
      if (oc >= ncg) break;
      const int c = cg0 + oc;
      __syncthreads();  // dS is in; every thread is done with the last chunk of K
      stage_f32(ks, kb + k0 * k_sl + c * kWideCols, k_sl, kF32Swept, krows,
                min(kWideCols, d - c * kWideCols));
      __syncthreads();
#pragma unroll 4
      for (int t = 0; t < kF32Swept; ++t) {
        float dsv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dsv[i] = qs[(r0 + 2 * i) * kF32Pitch + t];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) kv[jj] = ks[t * kF32Pitch + kq + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) dqa[oc][i][jj] = fmaf(dsv[i], kv[jj], dqa[oc][i][jj]);
      }
    }
  }

  const int64_t ld = static_cast<int64_t>(H) * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + 2 * i;
    if (row >= Lq) continue;
    float* const dqp = dq + (b * Lq + row) * ld + h * d;
#pragma unroll
    for (int oc = 0; oc < kGroupChunks; ++oc) {
      if (oc >= ncg) break;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = (cg0 + oc) * kWideCols + kq + 16 * jj;
        if (col < d) dqp[col] = dqa[oc][i][jj] * scale;
      }
    }
  }
}

// dynamic shared memory of the fp32 kernels
constexpr size_t kF32DkdvSmem =
    ((2 * kF32KeyRows + 2 * kF32Swept) * flash_mma::kF32Pitch + 2 * kF32Swept) * sizeof(float);
constexpr size_t kF32DqSmem =
    (2 * kF32QueryRows + 2 * kF32Swept) * flash_mma::kF32Pitch * sizeof(float);
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, Lq, Lk, H, d;
  int64_t q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, do_sb, do_sl;
  float scale;
  cudaStream_t stream;
};

// (tiles x split x H x B) CTAs in grid.x, or 0 past its 2^31 - 1
inline unsigned grid_x(int L, int rows, int split, const Args& a) {
  const int64_t n = static_cast<int64_t>((L + rows - 1) / rows) * split * a.H * a.B;
  return n <= 0x7fffffff ? static_cast<unsigned>(n) : 0u;
}

template <int DP>
int launch_fp32(const Args& a) {
  using C = Fp32Cfg<DP>;
  const unsigned grid_kv = grid_x(a.Lk, C::kRows, 1, a);
  const unsigned grid_q = grid_x(a.Lq, C::kRows, 1, a);
  if (!grid_kv || !grid_q) return static_cast<int>(cudaErrorInvalidConfiguration);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  flash_bwd_dkdv_fp32_kernel<DP><<<grid_kv, kFp32Threads, 0, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.Lq, a.Lk, a.H, a.d, a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.do_sb, a.do_sl,
      a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_fp32_kernel<DP><<<grid_q, kFp32Threads, 0, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dq), a.Lq, a.Lk, a.H, a.d, a.q_sb,
      a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.do_sb, a.do_sl, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_bf16(const Args& a) {
  using C = Bf16Cfg<DP>;
  const unsigned grid_kv = grid_x(a.Lk, flash_mma::kTile, C::kOutSplit, a);
  const unsigned grid_q = grid_x(a.Lq, flash_mma::kTile, 1, a);
  if (!grid_kv || !grid_q) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const auto dkdv = flash_bwd_dkdv_bf16_kernel<DP>;
  const auto dq = flash_bwd_dq_bf16_kernel<DP>;
  cudaError_t err = flash_mma::allow_smem(dkdv, C::kDkdvSmem);
  if (err == cudaSuccess) err = flash_mma::allow_smem(dq, C::kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv<<<grid_kv, flash_mma::kThreads, C::kDkdvSmem, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.Lq, a.Lk, a.H, a.d, a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.do_sb,
      a.do_sl, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq<<<grid_q, flash_mma::kThreads, C::kDqSmem, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dq), a.Lq, a.Lk, a.H, a.d,
      a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.do_sb, a.do_sl, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch(int dtype, const Args& a) {
  if (dtype == 0) return launch_fp32<DP>(a);
  if (dtype == 1) return launch_bf16<DP>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The column warps of a bf16 wide CTA at head dim d (2 row blocks of 32
// threads each)
int wide_warps(int d) {
  const int groups = flash_mma::wide_groups(d);
  return wide_column_warps((flash_mma::wide_chunks(d) + groups - 1) / groups);
}

// A bf16 wide kernel's staging plan at head dim d: own rows K, V (dK/dV) or
// Q, dO (dQ); swept Q, dO (both again for the output above 512 columns) or
// K, V (K again); exchanged, each warp's 16 x 32 partial S and dP.
bool wide_plan(flash_mma::WidePlan& p, int d, bool dkdv) {
  return flash_mma::plan_wide(p, d, 2 * kWideChunk, 2 * kWideChunk, (dkdv ? 2 : 1) * kWideChunk,
                              true, 2 * wide_warps(d) * 32 * 32 * 4);
}

// d > 256: the wide kernels, one CTA per (row tile, column group)
int launch_wide(int dtype, const Args& a) {
  using namespace flash_mma;
  const int groups = wide_groups(a.d);
  if (dtype == 0) {
    const unsigned grid_kv = grid_x(a.Lk, kF32KeyRows, groups, a);
    const unsigned grid_q = grid_x(a.Lq, kF32QueryRows, groups, a);
    if (!grid_kv || !grid_q) return static_cast<int>(cudaErrorInvalidConfiguration);
    const float* q = static_cast<const float*>(a.q);
    const float* k = static_cast<const float*>(a.k);
    const float* v = static_cast<const float*>(a.v);
    const float* dout = static_cast<const float*>(a.dout);
    cudaError_t err = allow_smem(flash_bwd_dkdv_wide_fp32_kernel, kF32DkdvSmem);
    if (err == cudaSuccess) err = allow_smem(flash_bwd_dq_wide_fp32_kernel, kF32DqSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkdv_wide_fp32_kernel<<<grid_kv, kF32Threads, kF32DkdvSmem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
        a.Lq, a.Lk, a.H, a.d, a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.do_sb,
        a.do_sl, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_wide_fp32_kernel<<<grid_q, kF32Threads, kF32DqSmem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dq), a.Lq, a.Lk, a.H, a.d,
        a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.do_sb, a.do_sl, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid_kv = grid_x(a.Lk, kWideRows, groups, a);
  const unsigned grid_q = grid_x(a.Lq, kWideRows, groups, a);
  if (!grid_kv || !grid_q) return static_cast<int>(cudaErrorInvalidConfiguration);
  WideArgs w{static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
             static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
             static_cast<bf16*>(a.dq), static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
             a.Lq, a.Lk, a.H, a.d, a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.do_sb,
             a.do_sl, a.scale, kStageElements, {}};
  if ((a.d & 7) == 0) w.mode = kStageTma;
  const int threads = 64 * wide_warps(a.d);
  CUtensorMap maps[4] = {};
  if (w.mode == kStageTma &&
      !(wide_map(&maps[0], a.q, a.B, a.Lq, a.H, a.d, a.q_sb, a.q_sl, kWideRows) &&
        wide_map(&maps[1], a.k, a.B, a.Lk, a.H, a.d, a.k_sb, a.k_sl, kWideRows) &&
        wide_map(&maps[2], a.v, a.B, a.Lk, a.H, a.d, a.v_sb, a.v_sl, kWideRows) &&
        wide_map(&maps[3], a.dout, a.B, a.Lq, a.H, a.d, a.do_sb, a.do_sl, kWideRows)))
    return static_cast<int>(cudaErrorInvalidValue);
  WideArgs wkv = w;
  if (!wide_plan(wkv.p, a.d, true)) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t smem_dkdv = allow_wide_smem(flash_bwd_dkdv_wide_bf16_kernel);
  static const cudaError_t smem_dq = allow_wide_smem(flash_bwd_dq_wide_bf16_kernel);
  cudaError_t err = smem_dkdv != cudaSuccess ? smem_dkdv : smem_dq;
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_wide_bf16_kernel<<<grid_kv, threads, wkv.p.smem_bytes, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], wkv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!wide_plan(w.p, a.d, false)) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dq_wide_bf16_kernel<<<grid_q, threads, w.p.smem_bytes, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// head_dim: any d >= 1 (above 256 the wide kernels); where d is a multiple
// of 8, bf16 q, k, v and dout must be 16-byte aligned with strides of
// whole 16-byte chunks, as the wrapper checks. Strides are in elements; dq/dk/dv are contiguous [B, L, H*d]. Returns the first
// failed launch's cudaError_t (0 = success).
extern "C" int ssl_vit_flash_bwd(int dtype, int head_dim, const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, void* dk,
                                 void* dv, int B, int Lq, int Lk, int H, int64_t q_sb,
                                 int64_t q_sl, int64_t k_sb, int64_t k_sl, int64_t v_sb,
                                 int64_t v_sl, int64_t do_sb, int64_t do_sl, float scale,
                                 void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, dk, dv, B, Lq, Lk, H, head_dim,
               q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, do_sb,
               do_sl, scale, static_cast<cudaStream_t>(stream)};
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

// The dynamic shared memory, in bytes, of the bf16 wide dK/dV (dkdv != 0)
// or dQ kernel at head dim d > 256 (0 where no plan fits).
extern "C" int ssl_vit_flash_bwd_wide_smem(int head_dim, int dkdv) {
  flash_mma::WidePlan p;
  return head_dim > flash_mma::kMaxHeadDim && wide_plan(p, head_dim, dkdv != 0) ? p.smem_bytes
                                                                                  : 0;
}

extern "C" const char* ssl_vit_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
