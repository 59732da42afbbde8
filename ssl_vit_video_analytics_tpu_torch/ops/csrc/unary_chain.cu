// Unary-chain throughput probe (P2) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel built by `make_kernel` and launched by
// `bench` in scripts/probe_exp.py. It computes the same thing: read an fp32
// block, cast it to the working type (fp32 or bf16), apply one op n times
// as a data-dependent chain, and write fp32:
//   exp:  a = exp(a * 0.12)
//   tanh: a = tanh(a + 0.1)
//   gelu: y = a + 0.1; a = y * (0.5 * (1 + tanh(sqrt(2/pi) * (y + 0.044715 * (y * (y * y))))))
//         (jax.nn.gelu's default tanh form, in its order of operations)
//   fma:  a = a * 0.9991 + 1e-4
// every constant taken in the working type. Each elementary operation is
// rounded to the working type (round to nearest even) as the plain PyTorch
// version (one PyTorch op per elementary operation) and the JAX expression
// round it; no multiply and add are contracted, not even in the fma op,
// whose product the plain version rounds before the add (an FFMA's single
// rounding drifts from it by 1.5e-5 of the largest magnitude over 516
// steps). n is a runtime argument, so the compiler cannot fold the chain.
//
// Design, for the card rather than carried over from the TPU (which ran
// one grid cell on a VMEM-resident block): a grid covers the elements;
// each thread loads 8 of them (two 16-byte loads) into registers once, runs
// 8 independent chains there, interleaved, so that the MUFU and FMA pipes
// have work in flight, and stores once at the end. Device-memory traffic
// stays constant while the work grows with n, which is the probe's intent.
// The main loop does 4 applications per trip (`kUnroll`), so its body is
// 32 applications of the op, and its three instructions of loop control
// cost about a twentieth of the issue slots of the cheapest op.
//
// bf16 stays packed: a thread holds its 8 values as 4 bf16x2 registers and
// does every multiply and add as one packed, correctly rounded bf16 op
// (mul.rn / add.rn.bf16x2; in SASS HMUL2.BF16_V2, HADD2.BF16_V2, or
// HFMA2.MMA.BF16_V2 with a -0 addend or a unit factor, which ptxas places
// on a second pipe; `.rn` keeps it from fusing a multiply with a later
// add). A
// correctly rounded bf16 + or x equals the fp32 op rounded to bf16: fp32's
// 24 bits are at least 2 x 8 + 2, so the double rounding is harmless, and
// the result equals the plain version bit for bit. Only exp and tanh leave
// bf16: each value of a pair is widened to fp32 by a shift on the integer
// pipe, goes through the accurate expf / tanhf, and the pair is narrowed
// by one cvt.rn.bf16x2.f32 (F2FP.BF16.F32.PACK_AB): half a conversion per
// element and application, and none for fma. Rounding each operation on
// its own (F2F.BF16.F32, 16 per clock per SM like the MUFU) would cost 2
// per application for exp, tanh and fma, 10 for gelu.
//
// What bounds it (H100 SXM at 1.98 GHz, 132 SMs; CUDA C programming
// guide's throughput table for compute capability 9.0): per application to
// 896 x 6272 = 5.62 M elements, at least
//   exp, tanh: one MUFU op per element at 16 per clock per SM: 1.34 us;
//   fma:       fp32, a multiply and an add at 128 per clock per SM:
//              0.336 us; bf16, the same two as packed ops, 256 results per
//              clock per SM: 0.168 us;
//   gelu:      one tanh (MUFU) and 9 multiplies and adds: 1.51 us in fp32
//              (the FMA pipe), 1.34 us in bf16 (the MUFU).
// What this kernel issues per element and application in its main loop is
// counted from `cuobjdump -sass` by the port's scripts/probe_exp.py --sass:
// expf is one MUFU.EX2 and 7 FMA-pipe instructions; the accurate tanhf is
// MUFU.EX2, MUFU.RCP and 14 others, so fp32 tanh and gelu are bound by
// issue slots rather than by the MUFU. The loads and stores are 45 MB,
// 0.013 ms at 3.35 TB/s, once per call. No fast-math flags.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kElems = 8;   // elements per thread, two float4
constexpr int kUnroll = 4;  // applications per trip of the main loop

enum Op { kExp = 0, kTanh = 1, kGelu = 2, kFma = 3 };

// ---- fp32: one rounding per operation, as a PyTorch op rounds it; the _rn
// intrinsics keep nvcc from contracting a multiply and an add into an FMA

template <int kOp>
__device__ __forceinline__ float apply_f32(float a) {
  if constexpr (kOp == kExp) {
    return expf(__fmul_rn(a, 0.12f));
  } else if constexpr (kOp == kTanh) {
    return tanhf(__fadd_rn(a, 0.1f));
  } else if constexpr (kOp == kGelu) {
    // op by op: over a 64-step chain, gelu's slope above 1 turns one
    // contraction's rounding difference into ~1e-4 of the result
    const float y = __fadd_rn(a, 0.1f);
    const float y3 = __fmul_rn(y, __fmul_rn(y, y));
    const float inner = __fadd_rn(y, __fmul_rn(0.044715f, y3));
    const float t = tanhf(__fmul_rn(0.7978845608028654f, inner));
    return __fmul_rn(y, __fmul_rn(0.5f, __fadd_rn(1.f, t)));
  } else {
    return __fadd_rn(__fmul_rn(a, 0.9991f), 1e-4f);
  }
}

// ---- bf16, packed: a uint32_t holds two bf16, element 2i in its low half

__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// widening is exact: the bf16 bits are the top half of the fp32 bits
__device__ __forceinline__ float lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

// both values rounded to nearest even by one cvt.rn.bf16x2.f32 (its first
// source goes to the high half)
__device__ __forceinline__ uint32_t pack(float l, float h) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(h), "f"(l));
  return d;
}

__device__ __forceinline__ uint32_t splat(float c) { return pack(c, c); }

// the constants, each rounded to bf16 and held in both halves
struct Bf16Consts {
  uint32_t exp, shift, cube, sqrt_2_over_pi, half, one, fma_mul, fma_add;
};

__device__ __forceinline__ Bf16Consts bf16_consts() {
  return {splat(0.12f), splat(0.1f),  splat(0.044715f), splat(0.7978845608028654f),
          splat(0.5f),  splat(1.f),   splat(0.9991f),   splat(1e-4f)};
}

template <int kOp>
__device__ __forceinline__ uint32_t apply_bf16x2(uint32_t a, const Bf16Consts& k) {
  if constexpr (kOp == kExp) {
    const uint32_t s = mul2(a, k.exp);
    return pack(expf(lo(s)), expf(hi(s)));
  } else if constexpr (kOp == kTanh) {
    const uint32_t s = add2(a, k.shift);
    return pack(tanhf(lo(s)), tanhf(hi(s)));
  } else if constexpr (kOp == kGelu) {
    const uint32_t y = add2(a, k.shift);
    const uint32_t y3 = mul2(y, mul2(y, y));
    const uint32_t s = mul2(k.sqrt_2_over_pi, add2(y, mul2(k.cube, y3)));
    const uint32_t t = pack(tanhf(lo(s)), tanhf(hi(s)));
    return mul2(y, mul2(k.half, add2(k.one, t)));
  } else {
    // the product is rounded before the add, as two PyTorch ops round it
    return add2(mul2(a, k.fma_mul), k.fma_add);
  }
}

// ---- the block's 8 elements of a thread, in and out

__device__ __forceinline__ void load8(const float* x, int64_t e0, int64_t numel, bool full,
                                      float (&v)[kElems]) {
  if (full) {
    const float4 t0 = __ldg(reinterpret_cast<const float4*>(x + e0));
    const float4 t1 = __ldg(reinterpret_cast<const float4*>(x + e0 + 4));
    v[0] = t0.x, v[1] = t0.y, v[2] = t0.z, v[3] = t0.w;
    v[4] = t1.x, v[5] = t1.y, v[6] = t1.z, v[7] = t1.w;
  } else {
#pragma unroll
    for (int j = 0; j < kElems; ++j) v[j] = e0 + j < numel ? x[e0 + j] : 0.f;
  }
}

__device__ __forceinline__ void store8(float* out, int64_t e0, int64_t numel, bool full,
                                       const float (&v)[kElems]) {
  if (full) {
    *reinterpret_cast<float4*>(out + e0) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(out + e0 + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < kElems; ++j)
      if (e0 + j < numel) out[e0 + j] = v[j];
  }
}

// Both kernels: not unrolled further, so that one trip of the main loop is
// kUnroll applications to each of a thread's kElems elements (what
// scripts/probe_exp.py --sass divides the loop's count by).

template <int kOp>
__global__ void __launch_bounds__(kThreads)
unary_chain_f32_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t numel,
                       int n) {
  const int64_t e0 = (blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x) * kElems;
  if (e0 >= numel) return;
  const bool full = e0 + kElems <= numel;
  float a[kElems];
  load8(x, e0, numel, full, a);
  int i = 0;
#pragma unroll 1
  for (; i + kUnroll <= n; i += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kElems; ++j) a[j] = apply_f32<kOp>(a[j]);
    }
  }
#pragma unroll 1
  for (; i < n; ++i) {
#pragma unroll
    for (int j = 0; j < kElems; ++j) a[j] = apply_f32<kOp>(a[j]);
  }
  store8(out, e0, numel, full, a);
}

template <int kOp>
__global__ void __launch_bounds__(kThreads)
unary_chain_bf16x2_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t numel,
                          int n) {
  const int64_t e0 = (blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x) * kElems;
  if (e0 >= numel) return;
  const bool full = e0 + kElems <= numel;
  const Bf16Consts k = bf16_consts();
  float v[kElems];
  load8(x, e0, numel, full, v);
  uint32_t a[kElems / 2];
#pragma unroll
  for (int j = 0; j < kElems / 2; ++j) a[j] = pack(v[2 * j], v[2 * j + 1]);
  int i = 0;
#pragma unroll 1
  for (; i + kUnroll <= n; i += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kElems / 2; ++j) a[j] = apply_bf16x2<kOp>(a[j], k);
    }
  }
#pragma unroll 1
  for (; i < n; ++i) {
#pragma unroll
    for (int j = 0; j < kElems / 2; ++j) a[j] = apply_bf16x2<kOp>(a[j], k);
  }
#pragma unroll
  for (int j = 0; j < kElems / 2; ++j) {
    v[2 * j] = lo(a[j]);
    v[2 * j + 1] = hi(a[j]);
  }
  store8(out, e0, numel, full, v);
}

template <int kOp, bool kBf16>
int launch(const float* x, float* out, int64_t numel, int n, cudaStream_t stream) {
  const int64_t threads = (numel + kElems - 1) / kElems;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  if constexpr (kBf16) {
    unary_chain_bf16x2_kernel<kOp><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, out, numel, n);
  } else {
    unary_chain_f32_kernel<kOp><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, out, numel, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int dispatch_op(int op, const float* x, float* out, int64_t numel, int n,
                cudaStream_t stream) {
  switch (op) {
    case kExp:
      return launch<kExp, kBf16>(x, out, numel, n, stream);
    case kTanh:
      return launch<kTanh, kBf16>(x, out, numel, n, stream);
    case kGelu:
      return launch<kGelu, kBf16>(x, out, numel, n, stream);
    case kFma:
      return launch<kFma, kBf16>(x, out, numel, n, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, loaded with ctypes. op: 0 exp, 1 tanh, 2 gelu, 3 fma; dtype:
// 0 = float32, 1 = bfloat16 (the working type; x and out are fp32). x and
// out are contiguous and 16-byte aligned (the wrapper checks). Returns the
// launch's cudaError_t (0 = success).
extern "C" int ssl_vit_unary_chain(int op, int dtype, const void* x, void* out,
                                   int64_t numel, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return dispatch_op<false>(op, xf, of, numel, n, s);
  if (dtype == 1) return dispatch_op<true>(op, xf, of, numel, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssl_vit_unary_chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
