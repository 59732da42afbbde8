// Flash-attention forward (K1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`, launched by `_fa_fwd_impl`
// in ssl_vit_video_analytics_tpu/ops/flash_attention.py. It computes the
// same thing: non-causal softmax(q k^T / sqrt(d)) v over PACKED heads
// (q/k/v are [B, L, H*d], head h owns columns [h*d, (h+1)*d)), writing
// `out` [B, Lq, H*d] in the input dtype and the per-row logsumexp of the
// scaled logits `lse` [B, Lq, H] in fp32 (the backward kernel reads it).
//
// Both kernels walk K/V in tiles with an ONLINE softmax (running max and
// sum in fp32), so any Lk fits; the TPU kernel kept all of K/V resident in
// VMEM for one exact pass, which bounds it to Lk of a few thousand. Key
// columns >= Lk are masked in the last tile; nothing is zero-padded in
// device memory, and zero tokens that the caller put in the sequence
// (MobileViT's 7x7 -> 8x8 pad) are real keys. Inputs are strided views: the
// row stride of q/k/v is a parameter (3*H*d for the thirds of a fused qkv
// projection), the last dim is contiguous.
//
// What bounds it: about 4*Lq*Lk*d flops per (batch row, head) against
// about 4*L*d elements of traffic, so it is bound by operations at every
// shape the models use. Two kernels, by dtype:
//
// - bf16, the working type of both main paths: flash_fwd_bf16_kernel runs
//   S = Q K^T and O += P V on the tensor cores (flash_mma.cuh: mma.sync
//   m16n8k16, bf16 operands, fp32 accumulators). One CTA of 4 warps per
//   (64-row query tile, head, batch row); each warp owns 16 query rows and
//   keeps their Q fragments in registers for the whole sweep. K and V come
//   in 64-key tiles through a 2-stage cp.async pipeline, so the copy of the
//   next tile overlaps the products on this one. The softmax runs on the
//   S accumulators in fp32 registers, in base 2 (scale * log2(e) folded
//   into one multiply before ex2), with the row max and sum reduced across
//   the quad of lanes that shares a row. P is rounded to bf16 unnormalised
//   and goes from the S accumulators straight into the A fragment of P V;
//   1/l is applied after the product, in `_fwd_kernel`'s own order.
// - fp32: flash_fwd_fp32_kernel, one thread per query row with fp32 FMAs
//   on the CUDA cores. TF32 tensor-core products would miss the 1e-4 to
//   which the fp32 training step is held against the plain path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using flash_mma::bf16;

constexpr int kBlockQ = 64;  // fp32: query rows per CTA, one thread each
constexpr int kBlockK = 32;  // fp32: keys per shared-memory tile
constexpr int kKeysBf16 = 64;  // bf16: keys per K/V tile (faster than 32 at d = 64)

template <int D>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int Lq, int Lk, int H,
                      int64_t q_sb, int64_t q_sl, int64_t k_sb, int64_t k_sl,
                      int64_t v_sb, int64_t v_sl, float scale) {
  __shared__ float ks[kBlockK][D];
  __shared__ float vs[kBlockK][D];

  const int tid = threadIdx.x;
  const int row = blockIdx.x * kBlockQ + tid;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  // rows past Lq compute on a copy of the last row and write nothing
  const int64_t qrow = row < Lq ? row : Lq - 1;

  float qr[D];
  const float* qp = q + b * q_sb + qrow * q_sl + h * D;
#pragma unroll
  for (int c = 0; c < D; ++c) qr[c] = qp[c] * scale;

  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  float m = -INFINITY;  // running max of the logits
  float l = 0.f;        // running sum of exp(logit - m)

  const float* kb = k + b * k_sb + h * D;
  const float* vb = v + b * v_sb + h * D;

  for (int k0 = 0; k0 < Lk; k0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < kBlockK * D; e += kBlockQ) {
      const int j = e / D;
      const int c = e - j * D;
      const int64_t key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < Lk) {
        kx = kb[key * k_sl + c];
        vx = vb[key * v_sl + c];
      }
      ks[j][c] = kx;
      vs[j][c] = vx;
    }
    __syncthreads();

    // every tile holds at least one key < Lk, so tile_max is finite
    float s[kBlockK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) dot = fmaf(qr[c], ks[j][c], dot);
      s[j] = (k0 + j < Lk) ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);  // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(s[j] - m_new);  // masked keys give exp(-inf) = 0
      l += p;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(p, vs[j][c], acc[c]);
    }
    m = m_new;
  }

  if (row < Lq) {
    const float inv = 1.f / l;
    float* op = out + (b * Lq + row) * (int64_t)(H * D) + h * D;
#pragma unroll
    for (int c = 0; c < D; ++c) op[c] = acc[c] * inv;
    lse[(b * Lq + row) * H + h] = m + logf(l);
  }
}

template <int D, int kKeys>
__global__ void __launch_bounds__(flash_mma::kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, int Lq, int Lk, int H, int64_t q_sb,
                      int64_t q_sl, int64_t k_sb, int64_t k_sl, int64_t v_sb, int64_t v_sl,
                      float scale) {
  using namespace flash_mma;
  using P = Dims<D>;
  static_assert(kKeys == 32 || kKeys == 64, "a key tile of 2 or 4 k16 blocks");
  constexpr int kStage = 2 * kKeys * P::kStride;  // a stage: K rows, then V rows
  // The 64-row Q tile rides in stage 1 until its fragments are in
  // registers, before the second key tile is loaded.
  __shared__ __align__(16) bf16 smem[2 * kStage];
  bf16* const ks[2] = {smem, smem + kStage};
  bf16* const vs[2] = {smem + kKeys * P::kStride, smem + kStage + kKeys * P::kStride};

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const bf16* kb = k + b * k_sb + h * D;
  const bf16* vb = v + b * v_sb + h * D;

  zero_pad_columns<D>(smem, 4 * kKeys);
  load_tile<D>(ks[1], q + b * q_sb + q0 * q_sl + h * D, q_sl, min(kTile, Lq - q0));
  load_tile<D, kKeys>(ks[0], kb, k_sl, min(kKeys, Lk));
  load_tile<D, kKeys>(vs[0], vb, v_sl, min(kKeys, Lk));
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[P::kK16][4];
  load_a<D>(qf, ks[1], warp * 16);
  __syncthreads();  // every warp holds its Q before stage 1 is overwritten

  const float sl2 = scale * kLog2e;  // logits -> base-2 exponents
  float o[P::kN8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g+8 (base 2)
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
  const int ntiles = (Lk + kKeys - 1) / kKeys;
  for (int n = 0; n < ntiles; ++n) {
    const int st = n & 1;
    if (n + 1 < ntiles) {
      const int k1 = (n + 1) * kKeys;
      load_tile<D, kKeys>(ks[st ^ 1], kb + k1 * k_sl, k_sl, min(kKeys, Lk - k1));
      load_tile<D, kKeys>(vs[st ^ 1], vb + k1 * v_sl, v_sl, min(kKeys, Lk - k1));
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
    for (int j = 0; j < kN / 2; ++j) mma_abt<D>(s[2 * j], s[2 * j + 1], qf, ks[st], 16 * j);

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
        mma_at<D>(o, a, vs[st], 16 * j);
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
  store_rows<D>(out + b * Lq * (int64_t)(H * D) + h * D, (int64_t)H * D, row0, Lq, o, inv[0],
                inv[1]);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + (lane >> 2) + 8 * r;
      if (row < Lq) lse[(b * Lq + row) * H + h] = m[r] * kLn2 + logf(l[r]);
    }
  }
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                int Lq, int Lk, int H, int64_t q_sb, int64_t q_sl, int64_t k_sb,
                int64_t k_sl, int64_t v_sb, int64_t v_sl, float scale,
                cudaStream_t stream) {
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_fp32_kernel<D><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Lq, Lk, H, q_sb, q_sl,
      k_sb, k_sl, v_sb, v_sl, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                int Lq, int Lk, int H, int64_t q_sb, int64_t q_sl, int64_t k_sb,
                int64_t k_sl, int64_t v_sb, int64_t v_sl, float scale,
                cudaStream_t stream) {
  const dim3 grid((Lq + flash_mma::kTile - 1) / flash_mma::kTile, H, B);
  flash_fwd_bf16_kernel<D, kKeysBf16><<<grid, flash_mma::kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, Lq, Lk, H, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Lq, int Lk, int H, int64_t q_sb, int64_t q_sl, int64_t k_sb,
           int64_t k_sl, int64_t v_sb, int64_t v_sl, float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_fp32<D>(q, k, v, out, lse, B, Lq, Lk, H, q_sb, q_sl, k_sb, k_sl, v_sb,
                          v_sl, scale, stream);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, out, lse, B, Lq, Lk, H, q_sb, q_sl, k_sb, k_sl, v_sb,
                          v_sl, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16 (q, k,
// v 16-byte aligned with strides of whole 16-byte chunks, as the wrapper
// checks). Strides are in elements. Returns the launch's cudaError_t.
extern "C" int ssl_vit_flash_fwd(int dtype, int head_dim, const void* q,
                                 const void* k, const void* v, void* out,
                                 void* lse, int B, int Lq, int Lk, int H,
                                 int64_t q_sb, int64_t q_sl, int64_t k_sb,
                                 int64_t k_sl, int64_t v_sb, int64_t v_sl,
                                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  switch (head_dim) {
    case 32:
      return launch<32>(dtype, q, k, v, out, lse_f, B, Lq, Lk, H, q_sb, q_sl, k_sb, k_sl,
                        v_sb, v_sl, scale, s);
    case 40:
      return launch<40>(dtype, q, k, v, out, lse_f, B, Lq, Lk, H, q_sb, q_sl, k_sb, k_sl,
                        v_sb, v_sl, scale, s);
    case 48:
      return launch<48>(dtype, q, k, v, out, lse_f, B, Lq, Lk, H, q_sb, q_sl, k_sb, k_sl,
                        v_sb, v_sl, scale, s);
    case 64:
      return launch<64>(dtype, q, k, v, out, lse_f, B, Lq, Lk, H, q_sb, q_sl, k_sb, k_sl,
                        v_sb, v_sl, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ssl_vit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
