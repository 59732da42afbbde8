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
// Wide heads, d > 256 (flash_bwd_{dkdv,dq}_wide_{bf16,fp32}_kernel, one
// instantiation each at flash_mma::kWideCols = 64), the scheme of dK/dV at
// width 256 carried to any number of column blocks: d is cut into nc =
// ceil(d / 64) chunks and a CTA owns one 64-column block of dK and dV (of
// its key tile) or of dQ (of its query tile). S^T and dP^T (or S and dP)
// are summed over every chunk of d, each chunk of K, V, Q and dO staged in
// shared memory in turn; then the block's own columns of dO and Q (or of
// K) are staged for dV += P^T dO, dK += dS^T Q (or dQ += dS K). The price:
// each of the nc CTAs of a tile recomputes S and dP over all of d, so for
// each 64 columns of d the two passes do 4 nc + 3 products where the
// kernels of a width do 7 (at d = 384, 27; at 1024, 67). bf16: 4 warps, 64-row tiles, every product on the
// tensor cores with A read from the staged chunk; each tile of the sweep
// takes nc + 1 steps of a 2-stage cp.async pipeline (72 KB of dynamic
// shared memory). fp32: 128 threads, 4 a row (32 rows a CTA), 32-row
// tiles; the CTA's own row's chunk goes into registers, the swept tile's
// through shared memory.

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

// fp32 wide heads: threads, threads per row, rows (keys or queries) a CTA
// owns and rows of the swept tiles
struct WideFp32 {
  static constexpr int kThreads = 128;
  static constexpr int kSplit = 4;
  static constexpr int kRows = kThreads / kSplit;
  static constexpr int kTile = 32;
};

template <int W>
__global__ void __launch_bounds__(WideFp32::kThreads)
flash_bwd_dkdv_wide_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk,
                                int H, int d, int64_t q_sb, int64_t q_sl, int64_t k_sb,
                                int64_t k_sl, int64_t v_sb, int64_t v_sl, int64_t do_sb,
                                int64_t do_sl, float scale) {
  using C = WideFp32;
  constexpr int S = C::kSplit, CT = W / S, T = C::kTile;
  __shared__ float qs[T][W];   // a chunk of Q, then this block's columns
  __shared__ float dos[T][W];  // the same of dO
  __shared__ float lse_s[T];
  __shared__ float delta_s[T];

  const int tid = threadIdx.x;
  const int part = tid % S;
  const int nc = (d + W - 1) / W;
  const GridIdx g = flash_mma::grid_idx((Lk + C::kRows - 1) / C::kRows * nc, H);
  const int cb = g.tile % nc;
  const int key = g.tile / nc * C::kRows + tid / S;
  const int h = g.h;
  const int64_t b = g.b;
  // keys past Lk compute on a copy of the last key and store nothing
  const int64_t krow = key < Lk ? key : Lk - 1;
  const float* kp = k + b * k_sb + krow * k_sl + h * d;
  const float* vp = v + b * v_sb + krow * v_sl + h * d;
  const float* qb = q + b * q_sb + h * d;
  const float* dob = dout + b * do_sb + h * d;
  const float* lse_b = lse + b * Lq * H + h;
  const float* delta_b = delta + b * Lq * H + h;
  const int ocols = min(W, d - cb * W);

  float dkr[CT], dvr[CT];
#pragma unroll
  for (int t = 0; t < CT; ++t) dkr[t] = dvr[t] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += T) {
    // this thread's partial S^T and dP^T over its columns of every chunk
    float s[T], dp[T];
#pragma unroll
    for (int i = 0; i < T; ++i) s[i] = dp[i] = 0.f;
    for (int c0 = 0; c0 < d; c0 += W) {
      float kr[CT], vr[CT];
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        const int c = c0 + S * t + part;
        kr[t] = c < d ? kp[c] : 0.f;
        vr[t] = c < d ? vp[c] : 0.f;
      }
      __syncthreads();  // every thread is done with the previous tile
      for (int e = tid; e < T * W; e += C::kThreads) {
        const int i = e / W;
        const int c = e - i * W;
        const int64_t row = q0 + i;
        const bool ok = row < Lq && c0 + c < d;
        qs[i][c] = ok ? qb[row * q_sl + c0 + c] : 0.f;
        dos[i][c] = ok ? dob[row * do_sl + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int t = 0; t < CT; ++t) {
          s[i] = fmaf(qs[i][S * t + part], kr[t], s[i]);
          dp[i] = fmaf(dos[i][S * t + part], vr[t], dp[i]);
        }
    }

    __syncthreads();
    for (int e = tid; e < T * W; e += C::kThreads) {
      const int i = e / W;
      const int c = e - i * W;
      const int64_t row = q0 + i;
      const bool ok = row < Lq && c < ocols;
      qs[i][c] = ok ? qb[row * q_sl + cb * W + c] : 0.f;
      dos[i][c] = ok ? dob[row * do_sl + cb * W + c] : 0.f;
    }
    if (tid < T) {
      const int64_t row = q0 + tid;
      lse_s[tid] = row < Lq ? lse_b[row * H] : 0.f;
      delta_s[tid] = row < Lq ? delta_b[row * H] : 0.f;
    }
    __syncthreads();

    const int n = min(T, Lq - q0);  // uniform over the CTA
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const float si = row_sum<S>(s[i]);
      const float dpi = row_sum<S>(dp[i]);
      const float p = i < n ? expf(si * scale - lse_s[i]) : 0.f;
      const float ds = p * (dpi - delta_s[i]);
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        dvr[t] = fmaf(p, dos[i][S * t + part], dvr[t]);
        dkr[t] = fmaf(ds, qs[i][S * t + part], dkr[t]);
      }
    }
  }

  if (key < Lk) {
    const int64_t o = (b * Lk + key) * (int64_t)H * d + h * d + cb * W;
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int c = S * t + part;
      if (c < ocols) {
        dk[o + c] = dkr[t] * scale;
        dv[o + c] = dvr[t];
      }
    }
  }
}

template <int W>
__global__ void __launch_bounds__(WideFp32::kThreads)
flash_bwd_dq_wide_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dq, int Lq, int Lk, int H, int d,
                              int64_t q_sb, int64_t q_sl, int64_t k_sb, int64_t k_sl,
                              int64_t v_sb, int64_t v_sl, int64_t do_sb, int64_t do_sl,
                              float scale) {
  using C = WideFp32;
  constexpr int S = C::kSplit, CT = W / S, T = C::kTile;
  __shared__ float ks[T][W];  // a chunk of K, then this block's columns
  __shared__ float vs[T][W];  // a chunk of V

  const int tid = threadIdx.x;
  const int part = tid % S;
  const int nc = (d + W - 1) / W;
  const GridIdx g = flash_mma::grid_idx((Lq + C::kRows - 1) / C::kRows * nc, H);
  const int cb = g.tile % nc;
  const int row = g.tile / nc * C::kRows + tid / S;
  const int h = g.h;
  const int64_t b = g.b;
  // rows past Lq compute on a copy of the last row and store nothing
  const int64_t qrow = row < Lq ? row : Lq - 1;
  const float* qp = q + b * q_sb + qrow * q_sl + h * d;
  const float* dop = dout + b * do_sb + qrow * do_sl + h * d;
  const float lse_r = lse[(b * Lq + qrow) * H + h];
  const float delta_r = delta[(b * Lq + qrow) * H + h];
  const float* kb = k + b * k_sb + h * d;
  const float* vb = v + b * v_sb + h * d;
  const int ocols = min(W, d - cb * W);

  float dqr[CT];
#pragma unroll
  for (int t = 0; t < CT; ++t) dqr[t] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += T) {
    float s[T], dp[T];
#pragma unroll
    for (int j = 0; j < T; ++j) s[j] = dp[j] = 0.f;
    for (int c0 = 0; c0 < d; c0 += W) {
      float qr[CT], dor[CT];
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        const int c = c0 + S * t + part;
        qr[t] = c < d ? qp[c] : 0.f;
        dor[t] = c < d ? dop[c] : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < T * W; e += C::kThreads) {
        const int j = e / W;
        const int c = e - j * W;
        const int64_t kk = k0 + j;
        const bool ok = kk < Lk && c0 + c < d;
        ks[j][c] = ok ? kb[kk * k_sl + c0 + c] : 0.f;
        vs[j][c] = ok ? vb[kk * v_sl + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < T; ++j)
#pragma unroll
        for (int t = 0; t < CT; ++t) {
          s[j] = fmaf(qr[t], ks[j][S * t + part], s[j]);
          dp[j] = fmaf(dor[t], vs[j][S * t + part], dp[j]);
        }
    }

    __syncthreads();
    for (int e = tid; e < T * W; e += C::kThreads) {
      const int j = e / W;
      const int c = e - j * W;
      const int64_t kk = k0 + j;
      ks[j][c] = kk < Lk && c < ocols ? kb[kk * k_sl + cb * W + c] : 0.f;
    }
    __syncthreads();

    const int n = min(T, Lk - k0);  // uniform over the CTA
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const float sj = row_sum<S>(s[j]);
      const float dpj = row_sum<S>(dp[j]);
      const float ds = j < n ? expf(sj * scale - lse_r) * (dpj - delta_r) : 0.f;
#pragma unroll
      for (int t = 0; t < CT; ++t) dqr[t] = fmaf(ds, ks[j][S * t + part], dqr[t]);
    }
  }

  if (row < Lq) {
    float* dqp = dq + (b * Lq + row) * (int64_t)H * d + h * d + cb * W;
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const int c = S * t + part;
      if (c < ocols) dqp[c] = dqr[t] * scale;
    }
  }
}

// bf16 wide heads: stage st holds 4 tiles of 64 rows x 64 columns
template <int W>
__device__ __forceinline__ bf16* wide_tile(bf16* smem, int st, int i) {
  return smem + (4 * st + i) * Dims<W>::kTileElems;
}

template <int W>
constexpr size_t kWideSmem = 8 * Dims<W>::kTileElems * sizeof(bf16);

template <int W>
__global__ void __launch_bounds__(flash_mma::kThreads)
flash_bwd_dkdv_wide_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                bf16* __restrict__ dk, bf16* __restrict__ dv, int Lq, int Lk,
                                int H, int d, int64_t q_sb, int64_t q_sl, int64_t k_sb,
                                int64_t k_sl, int64_t v_sb, int64_t v_sl, int64_t do_sb,
                                int64_t do_sl, float scale) {
  using namespace flash_mma;
  using P = Dims<W>;
  constexpr int kNQ = kTile / 8;  // n8 tiles of queries in S^T and dP^T
  // stage st: chunks of K, V, Q and dO in tiles 0-3, or this block's
  // columns of Q and dO in tiles 2-3 with the query tile's lse and delta
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ __align__(16) float lse_s[2][kTile];
  __shared__ __align__(16) float delta_s[2][kTile];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nc = (d + W - 1) / W;  // chunks of d, and column blocks of dK/dV
  const GridIdx g = grid_idx((Lk + kTile - 1) / kTile * nc, H);
  const int cb = g.tile % nc;
  const int k0 = g.tile / nc * kTile;
  const int h = g.h;
  const int64_t b = g.b;
  const bool vec = (d & 7) == 0;
  const int krows = min(kTile, Lk - k0);
  const bf16* kb = k + b * k_sb + k0 * k_sl + h * d;
  const bf16* vb = v + b * v_sb + k0 * v_sl + h * d;
  const bf16* qb = q + b * q_sb + h * d;
  const bf16* dob = dout + b * do_sb + h * d;
  const float* lse_b = lse + b * Lq * H + h;
  const float* delta_b = delta + b * Lq * H + h;
  const int ocols = min(W, d - cb * W);
  const int per = nc + 1;  // steps per query tile
  const int steps = (Lq + kTile - 1) / kTile * per;

  // issue the copies of step `i` into stage st: step c < nc of a query
  // tile stages chunk c of K, V, Q and dO; step nc this block's Q and dO
  auto issue = [&](int i, int st) {
    const int n = i / per, c = i - n * per;
    const int q1 = n * kTile, rows = min(kTile, Lq - q1);
    if (c < nc) {
      const int cols = min(W, d - c * W);
      load_chunk<W, kTile>(wide_tile<W>(smem, st, 0), kb + c * W, k_sl, krows, cols, vec);
      load_chunk<W, kTile>(wide_tile<W>(smem, st, 1), vb + c * W, v_sl, krows, cols, vec);
      load_chunk<W, kTile>(wide_tile<W>(smem, st, 2), qb + q1 * q_sl + c * W, q_sl, rows,
                           cols, vec);
      load_chunk<W, kTile>(wide_tile<W>(smem, st, 3), dob + q1 * do_sl + c * W, do_sl, rows,
                           cols, vec);
    } else {
      load_chunk<W, kTile>(wide_tile<W>(smem, st, 2), qb + q1 * q_sl + cb * W, q_sl, rows,
                           ocols, vec);
      load_chunk<W, kTile>(wide_tile<W>(smem, st, 3), dob + q1 * do_sl + cb * W, do_sl, rows,
                           ocols, vec);
      load_rows_stats(lse_s[st], delta_s[st], lse_b, delta_b, H, q1, Lq);
    }
  };

  const float sl2 = scale * kLog2e;
  float dka[P::kN8][4] = {}, dva[P::kN8][4] = {};
  float s[kNQ][4], dp[kNQ][4];
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
      if (c == 0) {
#pragma unroll
        for (int nt = 0; nt < kNQ; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      }
      // S^T += K_c Q_c^T and dP^T += V_c dO_c^T: this warp's 16 keys x 64 queries
#pragma unroll
      for (int j = 0; j < kNQ / 2; ++j) {
        mma_abt_s<W>(s[2 * j], s[2 * j + 1], wide_tile<W>(smem, st, 0), warp * 16,
                     wide_tile<W>(smem, st, 2), 16 * j);
        mma_abt_s<W>(dp[2 * j], dp[2 * j + 1], wide_tile<W>(smem, st, 1), warp * 16,
                     wide_tile<W>(smem, st, 3), 16 * j);
      }
    } else {
      const int qbase = n * kTile;
#pragma unroll
      for (int j = 0; j < kNQ / 2; ++j) {  // 16 query columns at a time
        if (qbase + 16 * j >= Lq) break;  // uniform: the rest of the tile is past Lq
#pragma unroll
        for (int nt = 2 * j; nt < 2 * j + 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = nt * 8 + 2 * (lane & 3) + (e & 1);  // query in the tile
            // query rows >= Lq: P = 0, as lse = +inf would give
            const float p = qbase + col < Lq
                                ? ex2(fmaf(s[nt][e], sl2, -lse_s[st][col] * kLog2e))
                                : 0.f;
            s[nt][e] = p;
            dp[nt][e] = p * (dp[nt][e] - delta_s[st][col]);
          }
        uint32_t pa[4], dsa[4];
        acc_to_a(pa, s[2 * j], s[2 * j + 1]);
        acc_to_a(dsa, dp[2 * j], dp[2 * j + 1]);
        mma_at<W, P::kN8>(dva, pa, wide_tile<W>(smem, st, 3), 16 * j);   // dV += P^T dO
        mma_at<W, P::kN8>(dka, dsa, wide_tile<W>(smem, st, 2), 16 * j);  // dK += dS^T Q
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  const int64_t ld = static_cast<int64_t>(H) * d;
  const int64_t off = b * Lk * ld + h * d;
  store_rows<P::kN8>(dk + off, ld, k0 + warp * 16, Lk, dka, scale, scale, d, cb * W);
  store_rows<P::kN8>(dv + off, ld, k0 + warp * 16, Lk, dva, 1.f, 1.f, d, cb * W);
}

template <int W>
__global__ void __launch_bounds__(flash_mma::kThreads)
flash_bwd_dq_wide_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dq, int Lq, int Lk, int H, int d,
                              int64_t q_sb, int64_t q_sl, int64_t k_sb, int64_t k_sl,
                              int64_t v_sb, int64_t v_sl, int64_t do_sb, int64_t do_sl,
                              float scale) {
  using namespace flash_mma;
  using P = Dims<W>;
  constexpr int kNK = kTile / 8;  // n8 tiles of keys in S and dP
  // stage st: chunks of Q, dO, K and V in tiles 0-3, or this block's
  // columns of K in tile 2
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const smem = reinterpret_cast<bf16*>(smem_raw);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nc = (d + W - 1) / W;  // chunks of d, and column blocks of dQ
  const GridIdx g = grid_idx((Lq + kTile - 1) / kTile * nc, H);
  const int cb = g.tile % nc;
  const int q0 = g.tile / nc * kTile;
  const int h = g.h;
  const int64_t b = g.b;
  const bool vec = (d & 7) == 0;
  const int qrows = min(kTile, Lq - q0);
  const bf16* qb = q + b * q_sb + q0 * q_sl + h * d;
  const bf16* dob = dout + b * do_sb + q0 * do_sl + h * d;
  const bf16* kb = k + b * k_sb + h * d;
  const bf16* vb = v + b * v_sb + h * d;
  const int ocols = min(W, d - cb * W);
  const int per = nc + 1;  // steps per key tile
  const int steps = (Lk + kTile - 1) / kTile * per;

  // issue the copies of step `i` into stage st: step c < nc of a key tile
  // stages chunk c of Q, dO, K and V; step nc this block's K
  auto issue = [&](int i, int st) {
    const int n = i / per, c = i - n * per;
    const int k1 = n * kTile, rows = min(kTile, Lk - k1);
    if (c < nc) {
      const int cols = min(W, d - c * W);
      load_chunk<W, kTile>(wide_tile<W>(smem, st, 0), qb + c * W, q_sl, qrows, cols, vec);
      load_chunk<W, kTile>(wide_tile<W>(smem, st, 1), dob + c * W, do_sl, qrows, cols, vec);
      load_chunk<W, kTile>(wide_tile<W>(smem, st, 2), kb + k1 * k_sl + c * W, k_sl, rows,
                           cols, vec);
      load_chunk<W, kTile>(wide_tile<W>(smem, st, 3), vb + k1 * v_sl + c * W, v_sl, rows,
                           cols, vec);
    } else {
      load_chunk<W, kTile>(wide_tile<W>(smem, st, 2), kb + k1 * k_sl + cb * W, k_sl, rows,
                           ocols, vec);
    }
  };

  // lse (base 2) and delta of rows g and g+8 of this warp; rows past Lq
  // read the last row and store nothing
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = min(q0 + warp * 16 + (lane >> 2) + 8 * r, Lq - 1);
    lse2[r] = lse[(b * Lq + row) * H + h] * kLog2e;
    dl[r] = delta[(b * Lq + row) * H + h];
  }

  const float sl2 = scale * kLog2e;
  float dqa[P::kN8][4] = {};
  float s[kNK][4], dp[kNK][4];
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
      if (c == 0) {
#pragma unroll
        for (int nt = 0; nt < kNK; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      }
      // S += Q_c K_c^T and dP += dO_c V_c^T: this warp's 16 rows x 64 keys
#pragma unroll
      for (int j = 0; j < kNK / 2; ++j) {
        mma_abt_s<W>(s[2 * j], s[2 * j + 1], wide_tile<W>(smem, st, 0), warp * 16,
                     wide_tile<W>(smem, st, 2), 16 * j);
        mma_abt_s<W>(dp[2 * j], dp[2 * j + 1], wide_tile<W>(smem, st, 1), warp * 16,
                     wide_tile<W>(smem, st, 3), 16 * j);
      }
    } else {
      const int kbase = n * kTile;
#pragma unroll
      for (int j = 0; j < kNK / 2; ++j) {  // 16 keys at a time
        if (kbase + 16 * j >= Lk) break;  // uniform: the rest of the tile is past Lk
#pragma unroll
        for (int nt = 2 * j; nt < 2 * j + 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kbase + nt * 8 + 2 * (lane & 3) + (e & 1);
            // keys >= Lk: P = 0, as S = -inf would give
            const float p = key < Lk ? ex2(fmaf(s[nt][e], sl2, -lse2[e >> 1])) : 0.f;
            dp[nt][e] = p * (dp[nt][e] - dl[e >> 1]);
          }
        uint32_t dsa[4];
        acc_to_a(dsa, dp[2 * j], dp[2 * j + 1]);
        mma_at<W, P::kN8>(dqa, dsa, wide_tile<W>(smem, st, 2), 16 * j);  // dQ += dS K
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  const int64_t ld = static_cast<int64_t>(H) * d;
  store_rows<P::kN8>(dq + b * Lq * ld + h * d, ld, q0 + warp * 16, Lq, dqa, scale, scale, d,
                     cb * W);
}

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

// d > 256: the wide kernels, one CTA per column block of 64 of each row tile
int launch_wide(int dtype, const Args& a) {
  constexpr int W = flash_mma::kWideCols;
  const int nc = (a.d + W - 1) / W;
  if (dtype == 0) {
    const unsigned grid_kv = grid_x(a.Lk, WideFp32::kRows, nc, a);
    const unsigned grid_q = grid_x(a.Lq, WideFp32::kRows, nc, a);
    if (!grid_kv || !grid_q) return static_cast<int>(cudaErrorInvalidConfiguration);
    const float* q = static_cast<const float*>(a.q);
    const float* k = static_cast<const float*>(a.k);
    const float* v = static_cast<const float*>(a.v);
    const float* dout = static_cast<const float*>(a.dout);
    flash_bwd_dkdv_wide_fp32_kernel<W><<<grid_kv, WideFp32::kThreads, 0, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
        a.Lq, a.Lk, a.H, a.d, a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.do_sb,
        a.do_sl, a.scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_wide_fp32_kernel<W><<<grid_q, WideFp32::kThreads, 0, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dq), a.Lq, a.Lk, a.H, a.d,
        a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.do_sb, a.do_sl, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid_kv = grid_x(a.Lk, flash_mma::kTile, nc, a);
  const unsigned grid_q = grid_x(a.Lq, flash_mma::kTile, nc, a);
  if (!grid_kv || !grid_q) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const auto dkdv = flash_bwd_dkdv_wide_bf16_kernel<W>;
  const auto dq = flash_bwd_dq_wide_bf16_kernel<W>;
  constexpr size_t smem = kWideSmem<W>;
  cudaError_t err = flash_mma::allow_smem(dkdv, smem);
  if (err == cudaSuccess) err = flash_mma::allow_smem(dq, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv<<<grid_kv, flash_mma::kThreads, smem, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.Lq, a.Lk, a.H, a.d, a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.do_sb,
      a.do_sl, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq<<<grid_q, flash_mma::kThreads, smem, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dq), a.Lq, a.Lk, a.H, a.d,
      a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.do_sb, a.do_sl, a.scale);
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

extern "C" const char* ssl_vit_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
