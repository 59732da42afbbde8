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
// in the input dtype (fp32 or bf16), with every sum in fp32.
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
// are contiguous [B, L, H*d].
//
// What bounds it: per (batch row, head) the backward does about
// 14*Lq*Lk*d flops against about (4*Lq + 4*Lk)*d elements of traffic per
// sweep, so it is bound by operations at every shape of the pipeline-B
// step. Two pairs of kernels, by dtype:
//
// - bf16, the working type of pretraining: every product on the tensor
//   cores (flash_mma.cuh: mma.sync m16n8k16, bf16 operands, fp32
//   accumulators), 4 warps per CTA, 16 rows each, and a 2-stage cp.async
//   pipeline of 64-row tiles, so the copy of the next tile overlaps the
//   products on this one.
//   * dkdv: each warp keeps its 16 keys' K and V fragments in registers and
//     computes S^T = K Q^T and dP^T = V dO^T with the keys as the M
//     dimension, 16 query columns at a time. P^T = exp2(S^T scale log2(e) -
//     lse log2(e)) and dS^T = P^T (dP^T - D) then already sit in the
//     accumulator layout that is the A fragment of dV += P^T dO and
//     dK += dS^T Q, with dO and Q read by ldmatrix.trans. P^T and dS^T are
//     rounded to bf16 before those products, as `_bwd_kernel` rounds them.
//   * dq: each warp keeps its 16 rows' Q and dO fragments in registers,
//     computes S and dP over 16 keys at a time, dS = P (dP - D) rounded to
//     bf16, and dQ += dS K with K read by ldmatrix.trans.
// - fp32: the CUDA-core kernels, two threads per row (thread `half` of a
//   pair owns the columns c = 2t + half, one shuffle per dot product), fp32
//   FMAs. TF32 tensor-core products would miss the 1e-4 to which the fp32
//   training step is held against the plain path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using flash_mma::bf16;

constexpr int kRows = 64;                 // fp32: rows (keys or queries) per CTA
constexpr int kSplit = 2;                 // fp32: threads per row
constexpr int kThreads = kRows * kSplit;  // 128
constexpr int kTileQ = 64;                // fp32: query rows staged per step (dkdv)
constexpr int kTileK = 32;                // fp32: keys staged per step (dq)

// sum of the two partial dot products of a thread pair (adjacent lanes)
__device__ __forceinline__ float pair_sum(float x) {
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk,
                           int H, int64_t q_sb, int64_t q_sl, int64_t k_sb, int64_t k_sl,
                           int64_t v_sb, int64_t v_sl, int64_t do_sb, int64_t do_sl,
                           float scale) {
  constexpr int DH = D / kSplit;
  __shared__ float qs[kTileQ][D];
  __shared__ float dos[kTileQ][D];
  __shared__ float lse_s[kTileQ];
  __shared__ float delta_s[kTileQ];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int key = blockIdx.x * kRows + (tid >> 1);
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  // keys past Lk compute on a copy of the last key and store nothing
  const int64_t krow = key < Lk ? key : Lk - 1;

  float kr[DH], vr[DH], dkr[DH], dvr[DH];
  const float* kp = k + b * k_sb + krow * k_sl + h * D;
  const float* vp = v + b * v_sb + krow * v_sl + h * D;
#pragma unroll
  for (int t = 0; t < DH; ++t) {
    kr[t] = kp[2 * t + half];
    vr[t] = vp[2 * t + half];
    dkr[t] = 0.f;
    dvr[t] = 0.f;
  }

  const float* qb = q + b * q_sb + h * D;
  const float* dob = dout + b * do_sb + h * D;
  const float* lse_b = lse + b * Lq * H + h;
  const float* delta_b = delta + b * Lq * H + h;

  for (int q0 = 0; q0 < Lq; q0 += kTileQ) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < kTileQ * D; e += kThreads) {
      const int i = e / D;
      const int c = e - i * D;
      const int64_t row = q0 + i;
      float qx = 0.f, dx = 0.f;
      if (row < Lq) {
        qx = qb[row * q_sl + c];
        dx = dob[row * do_sl + c];
      }
      qs[i][c] = qx;
      dos[i][c] = dx;
    }
    if (tid < kTileQ) {
      const int64_t row = q0 + tid;
      lse_s[tid] = row < Lq ? lse_b[row * H] : 0.f;
      delta_s[tid] = row < Lq ? delta_b[row * H] : 0.f;
    }
    __syncthreads();

    // uniform over the CTA: the shuffles below see every lane
    const int n = min(kTileQ, Lq - q0);
    for (int i = 0; i < n; ++i) {
      float s0 = 0.f, s1 = 0.f, dp0 = 0.f, dp1 = 0.f;
#pragma unroll
      for (int t = 0; t < DH; t += 2) {
        s0 = fmaf(qs[i][2 * t + half], kr[t], s0);
        dp0 = fmaf(dos[i][2 * t + half], vr[t], dp0);
        if (t + 1 < DH) {
          s1 = fmaf(qs[i][2 * t + 2 + half], kr[t + 1], s1);
          dp1 = fmaf(dos[i][2 * t + 2 + half], vr[t + 1], dp1);
        }
      }
      const float s = pair_sum(s0 + s1);
      const float dp = pair_sum(dp0 + dp1);
      const float p = expf(s * scale - lse_s[i]);
      const float ds = p * (dp - delta_s[i]);
#pragma unroll
      for (int t = 0; t < DH; ++t) {
        dvr[t] = fmaf(p, dos[i][2 * t + half], dvr[t]);
        dkr[t] = fmaf(ds, qs[i][2 * t + half], dkr[t]);
      }
    }
  }

  if (key < Lk) {
    const int64_t o = (b * Lk + key) * (int64_t)(H * D) + h * D;
#pragma unroll
    for (int t = 0; t < DH; ++t) {
      dk[o + 2 * t + half] = dkr[t] * scale;
      dv[o + 2 * t + half] = dvr[t];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int Lq, int Lk, int H, int64_t q_sb,
                         int64_t q_sl, int64_t k_sb, int64_t k_sl, int64_t v_sb,
                         int64_t v_sl, int64_t do_sb, int64_t do_sl, float scale) {
  constexpr int DH = D / kSplit;
  __shared__ float ks[kTileK][D];
  __shared__ float vs[kTileK][D];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int row = blockIdx.x * kRows + (tid >> 1);
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  // rows past Lq compute on a copy of the last row and store nothing
  const int64_t qrow = row < Lq ? row : Lq - 1;

  float qr[DH], dor[DH], dqr[DH];
  const float* qp = q + b * q_sb + qrow * q_sl + h * D;
  const float* dop = dout + b * do_sb + qrow * do_sl + h * D;
#pragma unroll
  for (int t = 0; t < DH; ++t) {
    qr[t] = qp[2 * t + half];
    dor[t] = dop[2 * t + half];
    dqr[t] = 0.f;
  }
  const float lse_r = lse[(b * Lq + qrow) * H + h];
  const float delta_r = delta[(b * Lq + qrow) * H + h];

  const float* kb = k + b * k_sb + h * D;
  const float* vb = v + b * v_sb + h * D;

  for (int k0 = 0; k0 < Lk; k0 += kTileK) {
    __syncthreads();
    for (int e = tid; e < kTileK * D; e += kThreads) {
      const int j = e / D;
      const int c = e - j * D;
      const int64_t kk = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kk < Lk) {
        kx = kb[kk * k_sl + c];
        vx = vb[kk * v_sl + c];
      }
      ks[j][c] = kx;
      vs[j][c] = vx;
    }
    __syncthreads();

    const int n = min(kTileK, Lk - k0);
    for (int j = 0; j < n; ++j) {
      float s0 = 0.f, s1 = 0.f, dp0 = 0.f, dp1 = 0.f;
#pragma unroll
      for (int t = 0; t < DH; t += 2) {
        s0 = fmaf(qr[t], ks[j][2 * t + half], s0);
        dp0 = fmaf(dor[t], vs[j][2 * t + half], dp0);
        if (t + 1 < DH) {
          s1 = fmaf(qr[t + 1], ks[j][2 * t + 2 + half], s1);
          dp1 = fmaf(dor[t + 1], vs[j][2 * t + 2 + half], dp1);
        }
      }
      const float s = pair_sum(s0 + s1);
      const float dp = pair_sum(dp0 + dp1);
      const float ds = expf(s * scale - lse_r) * (dp - delta_r);
#pragma unroll
      for (int t = 0; t < DH; ++t) dqr[t] = fmaf(ds, ks[j][2 * t + half], dqr[t]);
    }
  }

  if (row < Lq) {
    float* dqp = dq + (b * Lq + row) * (int64_t)(H * D) + h * D;
#pragma unroll
    for (int t = 0; t < DH; ++t) dqp[2 * t + half] = dqr[t] * scale;
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

template <int D>
__global__ void __launch_bounds__(flash_mma::kThreads)
flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int Lq, int Lk,
                           int H, int64_t q_sb, int64_t q_sl, int64_t k_sb, int64_t k_sl,
                           int64_t v_sb, int64_t v_sl, int64_t do_sb, int64_t do_sl,
                           float scale) {
  using namespace flash_mma;
  using P = Dims<D>;
  // Q stages 0-1, then dO stages 0-1. The CTA's K and V tiles ride in stage
  // 1 until their fragments are in registers.
  __shared__ __align__(16) bf16 smem[4 * P::kTileElems];
  __shared__ __align__(16) float lse_s[2][kTile];
  __shared__ __align__(16) float delta_s[2][kTile];
  bf16* const qs[2] = {smem, smem + P::kTileElems};
  bf16* const dos[2] = {smem + 2 * P::kTileElems, smem + 3 * P::kTileElems};

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const bf16* qb = q + b * q_sb + h * D;
  const bf16* dob = dout + b * do_sb + h * D;
  const float* lse_b = lse + b * Lq * H + h;
  const float* delta_b = delta + b * Lq * H + h;

  zero_pad_columns<D>(smem, 4 * kTile);
  load_tile<D>(qs[1], k + b * k_sb + k0 * k_sl + h * D, k_sl, min(kTile, Lk - k0));
  load_tile<D>(dos[1], v + b * v_sb + k0 * v_sl + h * D, v_sl, min(kTile, Lk - k0));
  load_tile<D>(qs[0], qb, q_sl, min(kTile, Lq));
  load_tile<D>(dos[0], dob, do_sl, min(kTile, Lq));
  load_rows_stats(lse_s[0], delta_s[0], lse_b, delta_b, H, 0, Lq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[P::kK16][4], vf[P::kK16][4];
  load_a<D>(kf, qs[1], warp * 16);
  load_a<D>(vf, dos[1], warp * 16);
  __syncthreads();  // every warp holds its K and V before stage 1 is overwritten

  const float sl2 = scale * kLog2e;
  float dka[P::kN8][4] = {}, dva[P::kN8][4] = {};
  const int ntiles = (Lq + kTile - 1) / kTile;
  for (int n = 0; n < ntiles; ++n) {
    const int st = n & 1;
    if (n + 1 < ntiles) {
      const int q1 = (n + 1) * kTile;
      load_tile<D>(qs[st ^ 1], qb + q1 * q_sl, q_sl, min(kTile, Lq - q1));
      load_tile<D>(dos[st ^ 1], dob + q1 * do_sl, do_sl, min(kTile, Lq - q1));
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
      mma_abt<D>(s[0], s[1], kf, qs[st], 16 * j);
      mma_abt<D>(dp[0], dp[1], vf, dos[st], 16 * j);
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
      mma_at<D>(dva, pa, dos[st], 16 * j);   // dV += P^T dO
      mma_at<D>(dka, dsa, qs[st], 16 * j);   // dK += dS^T Q
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  const int64_t ld = static_cast<int64_t>(H) * D;
  const int64_t off = b * Lk * ld + h * D;
  store_rows<D>(dk + off, ld, k0 + warp * 16, Lk, dka, scale, scale);
  store_rows<D>(dv + off, ld, k0 + warp * 16, Lk, dva, 1.f, 1.f);
}

template <int D>
__global__ void __launch_bounds__(flash_mma::kThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int Lq, int Lk, int H, int64_t q_sb,
                         int64_t q_sl, int64_t k_sb, int64_t k_sl, int64_t v_sb,
                         int64_t v_sl, int64_t do_sb, int64_t do_sl, float scale) {
  using namespace flash_mma;
  using P = Dims<D>;
  // K stages 0-1, then V stages 0-1. The CTA's Q and dO tiles ride in stage
  // 1 until their fragments are in registers.
  __shared__ __align__(16) bf16 smem[4 * P::kTileElems];
  bf16* const ks[2] = {smem, smem + P::kTileElems};
  bf16* const vs[2] = {smem + 2 * P::kTileElems, smem + 3 * P::kTileElems};

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const bf16* kb = k + b * k_sb + h * D;
  const bf16* vb = v + b * v_sb + h * D;

  zero_pad_columns<D>(smem, 4 * kTile);
  load_tile<D>(ks[1], q + b * q_sb + q0 * q_sl + h * D, q_sl, min(kTile, Lq - q0));
  load_tile<D>(vs[1], dout + b * do_sb + q0 * do_sl + h * D, do_sl, min(kTile, Lq - q0));
  load_tile<D>(ks[0], kb, k_sl, min(kTile, Lk));
  load_tile<D>(vs[0], vb, v_sl, min(kTile, Lk));
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
  uint32_t qf[P::kK16][4], df[P::kK16][4];
  load_a<D>(qf, ks[1], warp * 16);
  load_a<D>(df, vs[1], warp * 16);
  __syncthreads();  // every warp holds its Q and dO before stage 1 is overwritten

  const float sl2 = scale * kLog2e;
  float dqa[P::kN8][4] = {};
  const int ntiles = (Lk + kTile - 1) / kTile;
  for (int n = 0; n < ntiles; ++n) {
    const int st = n & 1;
    if (n + 1 < ntiles) {
      const int k1 = (n + 1) * kTile;
      load_tile<D>(ks[st ^ 1], kb + k1 * k_sl, k_sl, min(kTile, Lk - k1));
      load_tile<D>(vs[st ^ 1], vb + k1 * v_sl, v_sl, min(kTile, Lk - k1));
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
      mma_abt<D>(s[0], s[1], qf, ks[st], 16 * j);   // S = Q K^T
      mma_abt<D>(dp[0], dp[1], df, vs[st], 16 * j);  // dP = dO V^T
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
      mma_at<D>(dqa, dsa, ks[st], 16 * j);  // dQ += dS K
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  const int64_t ld = static_cast<int64_t>(H) * D;
  store_rows<D>(dq + b * Lq * ld + h * D, ld, q0 + warp * 16, Lq, dqa, scale, scale);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, Lq, Lk, H;
  int64_t q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, do_sb, do_sl;
  float scale;
  cudaStream_t stream;
};

// the dK/dV kernel, then the dQ kernel, on one stream
template <typename T, typename DkDv, typename Dq>
int launch_pair(const Args& a, DkDv dkdv, Dq dq, int threads, int rows) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const dim3 grid_kv((a.Lk + rows - 1) / rows, a.H, a.B);
  dkdv<<<grid_kv, threads, 0, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Lq,
      a.Lk, a.H, a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.do_sb, a.do_sl, a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((a.Lq + rows - 1) / rows, a.H, a.B);
  dq<<<grid_q, threads, 0, a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq),
                                       a.Lq, a.Lk, a.H, a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb,
                                       a.v_sl, a.do_sb, a.do_sl, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const Args& a) {
  if (dtype == 0)
    return launch_pair<float>(a, flash_bwd_dkdv_fp32_kernel<D>, flash_bwd_dq_fp32_kernel<D>,
                              kThreads, kRows);
  if (dtype == 1)
    return launch_pair<bf16>(a, flash_bwd_dkdv_bf16_kernel<D>, flash_bwd_dq_bf16_kernel<D>,
                             flash_mma::kThreads, flash_mma::kTile);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16 (q, k,
// v and dout 16-byte aligned with strides of whole 16-byte chunks, as the
// wrapper checks). Strides are in elements; dq/dk/dv are contiguous
// [B, L, H*d]. Returns the first launch's cudaError_t (0 = success).
extern "C" int ssl_vit_flash_bwd(int dtype, int head_dim, const void* q,
                                 const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, void* dk,
                                 void* dv, int B, int Lq, int Lk, int H,
                                 int64_t q_sb, int64_t q_sl, int64_t k_sb,
                                 int64_t k_sl, int64_t v_sb, int64_t v_sl,
                                 int64_t do_sb, int64_t do_sl, float scale,
                                 void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, dk, dv, B, Lq, Lk, H,
               q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, do_sb, do_sl, scale,
               static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 32: return launch<32>(dtype, a);
    case 40: return launch<40>(dtype, a);
    case 48: return launch<48>(dtype, a);
    case 64: return launch<64>(dtype, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ssl_vit_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
