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
// Design, for the card rather than carried over from the TPU:
// - The TPU kernel walks the q-blocks of one batch row IN ORDER and carries
//   dK/dV in VMEM scratch from one grid step to the next. CTAs run
//   concurrently and in no order, so that scheme would race. Here the work
//   is split FA2-style into two kernels, each of which owns its outputs:
//   * dkdv: one CTA per (64-key tile, head, batch row) loops over ALL query
//     rows, staging 64-row tiles of q and dO through shared memory, and
//     keeps its keys' dK/dV accumulators in registers. Nothing is shared
//     across CTAs, so no atomics and a fixed summation order.
//   * dq: one CTA per (64-row query tile, head, batch row) loops over all
//     keys in 32-key tiles, as K1 does, and keeps dQ in registers.
//   S and dP are recomputed in both (7 products per tile instead of the
//   fused kernel's 5); in exchange every output has exactly one writer.
// - Two threads share a row (a key row in dkdv, a query row in dq). Thread
//   `half` of the pair owns the columns c = 2t + half, so a row's k, v and
//   dK, dV accumulators take 2*d floats of registers per thread (128 at
//   d = 64) instead of 4*d (K1 already sits at 252 registers at d = 64).
//   The two partial dot products of a pair are summed with one shuffle.
//   The pair reads adjacent words of a staged row, and every pair of a
//   warp reads the same row: two distinct addresses in two banks, one
//   shared-memory transaction.
// - Keys >= Lk and rows >= Lq are masked explicitly: staged tiles are
//   zero-filled past the edge and the inner loops stop at the edge; rows
//   past the edge compute on a copy of the last row and store nothing. The
//   TPU kernel instead relied on zero-padded K/V/dO rows.
// - Inputs are strided views, as in K1 (row stride 3*H*d for the thirds of
//   a fused qkv projection); dO has its own strides; outputs are
//   contiguous [B, L, H*d].
//
// What bounds it: per (batch row, head) the backward does ~14*Lq*Lk*d
// flops (S and dP twice, dV, dK, dQ) against ~(4*Lq + 4*Lk)*d elements of
// traffic per CTA sweep, so it is compute-bound at every shape of the
// pipeline-B step, and this simple version runs those flops as fp32 FMAs
// on the CUDA cores. Tensor-core products (mma.sync / wgmma on bf16 tiles)
// and a fused single pass are the next steps for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                 // rows (keys or queries) per CTA
constexpr int kSplit = 2;                 // threads per row
constexpr int kThreads = kRows * kSplit;  // 128
constexpr int kTileQ = 64;                // query rows staged per step (dkdv)
constexpr int kTileK = 32;                // keys staged per step (dq)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// sum of the two partial dot products of a thread pair (adjacent lanes)
__device__ __forceinline__ float pair_sum(float x) {
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Lq, int Lk, int H,
                      int64_t q_sb, int64_t q_sl, int64_t k_sb, int64_t k_sl,
                      int64_t v_sb, int64_t v_sl, int64_t do_sb,
                      int64_t do_sl, float scale) {
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
  const T* kp = k + b * k_sb + krow * k_sl + h * D;
  const T* vp = v + b * v_sb + krow * v_sl + h * D;
#pragma unroll
  for (int t = 0; t < DH; ++t) {
    kr[t] = to_float(kp[2 * t + half]);
    vr[t] = to_float(vp[2 * t + half]);
    dkr[t] = 0.f;
    dvr[t] = 0.f;
  }

  const T* qb = q + b * q_sb + h * D;
  const T* dob = dout + b * do_sb + h * D;
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
        qx = to_float(qb[row * q_sl + c]);
        dx = to_float(dob[row * do_sl + c]);
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
      dk[o + 2 * t + half] = from_float<T>(dkr[t] * scale);
      dv[o + 2 * t + half] = from_float<T>(dvr[t]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Lq, int Lk, int H, int64_t q_sb, int64_t q_sl,
                    int64_t k_sb, int64_t k_sl, int64_t v_sb, int64_t v_sl,
                    int64_t do_sb, int64_t do_sl, float scale) {
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
  const T* qp = q + b * q_sb + qrow * q_sl + h * D;
  const T* dop = dout + b * do_sb + qrow * do_sl + h * D;
#pragma unroll
  for (int t = 0; t < DH; ++t) {
    qr[t] = to_float(qp[2 * t + half]);
    dor[t] = to_float(dop[2 * t + half]);
    dqr[t] = 0.f;
  }
  const float lse_r = lse[(b * Lq + qrow) * H + h];
  const float delta_r = delta[(b * Lq + qrow) * H + h];

  const T* kb = k + b * k_sb + h * D;
  const T* vb = v + b * v_sb + h * D;

  for (int k0 = 0; k0 < Lk; k0 += kTileK) {
    __syncthreads();
    for (int e = tid; e < kTileK * D; e += kThreads) {
      const int j = e / D;
      const int c = e - j * D;
      const int64_t kk = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kk < Lk) {
        kx = to_float(kb[kk * k_sl + c]);
        vx = to_float(vb[kk * v_sl + c]);
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
    T* dqp = dq + (b * Lq + row) * (int64_t)(H * D) + h * D;
#pragma unroll
    for (int t = 0; t < DH; ++t) dqp[2 * t + half] = from_float<T>(dqr[t] * scale);
  }
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

template <typename T, int D>
int launch(const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const dim3 grid_kv((a.Lk + kRows - 1) / kRows, a.H, a.B);
  flash_bwd_dkdv_kernel<T, D><<<grid_kv, kThreads, 0, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.Lq, a.Lk, a.H, a.q_sb, a.q_sl, a.k_sb, a.k_sl,
      a.v_sb, a.v_sl, a.do_sb, a.do_sl, a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((a.Lq + kRows - 1) / kRows, a.H, a.B);
  flash_bwd_dq_kernel<T, D><<<grid_q, kThreads, 0, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.Lq, a.Lk, a.H,
      a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl, a.do_sb, a.do_sl,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_head_dim(int D, const Args& a) {
  switch (D) {
    case 32: return launch<T, 32>(a);
    case 40: return launch<T, 40>(a);
    case 48: return launch<T, 48>(a);
    case 64: return launch<T, 64>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Strides are in elements; dq/dk/dv are contiguous [B, L, H*d].
// Returns the first launch's cudaError_t (0 = success).
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
  if (dtype == 0) return dispatch_head_dim<float>(head_dim, a);
  if (dtype == 1) return dispatch_head_dim<__nv_bfloat16>(head_dim, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssl_vit_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
