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
// computed in fp32 and, in bf16, rounded to bf16 (round to nearest even),
// as the plain PyTorch version (one PyTorch op per elementary operation)
// and the JAX expression round; no multiply and add are contracted, not
// even in the fma op, whose product the plain version rounds before the
// add (an FFMA's single rounding drifts from it by 1.5e-5 of the largest
// magnitude over 516 steps). n is a runtime argument, so the compiler
// cannot fold the chain.
//
// Design, for the card rather than carried over from the TPU: the TPU
// kernel ran one grid cell on a VMEM-resident block. Here a grid covers the
// elements; each thread loads 4 of them (one 16-byte load) into registers
// once, runs 4 independent chains there, interleaved, so that the MUFU and
// FMA pipes have independent work in flight, and stores once at the end.
// Device-memory traffic stays constant while the work grows with n, which
// is the probe's intent. The chain's main loop does 8 applications per
// trip (`kUnroll`), so its body is 32 applications of the op, and its
// three instructions of loop control cost about a twentieth of the issue
// slots of the cheapest op (fp32 fma, 32 FMULs and 32 FADDs a trip).
//
// What bounds it (H100 SXM at 1.98 GHz, 132 SMs; CUDA C programming
// guide's throughput table for compute capability 9.0): per application to
// 896 x 6272 = 5.62 M elements, at least
//   exp, tanh: one MUFU op per element at 16 per clock per SM: 1.34 us;
//   fma:       a multiply and an add, two FMA-pipe ops per element at 128
//              per clock per SM: 0.336 us;
//   gelu:      one tanh (MUFU) and about 7 FMA-pipe ops: 1.34 us.
// What this kernel issues per element and application in its main loop
// (`cuobjdump -sass`, counted by the port's scripts/probe_exp.py --sass):
// expf is one MUFU.EX2 and 7 FMA-pipe instructions; the accurate tanhf is
// MUFU.EX2, MUFU.RCP and 14 others; gelu is tanhf and 8 more; fma is an
// FMUL and an FADD. Each bf16 rounding is an F2F.BF16.F32 (a conversion, 16 per clock
// per SM like the MUFU ops in the guide's table) and a shift back, so in
// bf16 the conversions, not the arithmetic, set the pace (2 per
// application for exp, tanh and fma, 10 for gelu). The loads and stores
// are 45 MB, 0.013 ms at 3.35 TB/s, once per call. No fast-math flags:
// expf and tanhf are the accurate library functions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kElems = 4;   // elements per thread, one float4
constexpr int kUnroll = 8;  // applications per trip of the main loop

enum Op { kExp = 0, kTanh = 1, kGelu = 2, kFma = 3 };

// the value rounded to the working type
template <bool kBf16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kBf16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// one elementary operation, rounded as a PyTorch op rounds it: the _rn
// intrinsics keep nvcc from contracting a multiply and an add into an FMA
template <bool kBf16>
__device__ __forceinline__ float mul(float a, float b) {
  return rnd<kBf16>(__fmul_rn(a, b));
}
template <bool kBf16>
__device__ __forceinline__ float add(float a, float b) {
  return rnd<kBf16>(__fadd_rn(a, b));
}

template <int kOp, bool kBf16>
__device__ __forceinline__ float apply(float a) {
  if constexpr (kOp == kExp) {
    return rnd<kBf16>(expf(mul<kBf16>(a, rnd<kBf16>(0.12f))));
  } else if constexpr (kOp == kTanh) {
    return rnd<kBf16>(tanhf(add<kBf16>(a, rnd<kBf16>(0.1f))));
  } else if constexpr (kOp == kGelu) {
    // op by op: over a 64-step chain, gelu's slope above 1 turns one
    // contraction's rounding difference into ~1e-4 of the result
    const float y = add<kBf16>(a, rnd<kBf16>(0.1f));
    const float y3 = mul<kBf16>(y, mul<kBf16>(y, y));
    const float inner = add<kBf16>(y, mul<kBf16>(rnd<kBf16>(0.044715f), y3));
    const float t = rnd<kBf16>(tanhf(mul<kBf16>(rnd<kBf16>(0.7978845608028654f), inner)));
    const float cdf = mul<kBf16>(0.5f, add<kBf16>(1.f, t));
    return mul<kBf16>(y, cdf);
  } else {
    // the product is rounded before the add, as two PyTorch ops round it
    return add<kBf16>(mul<kBf16>(a, rnd<kBf16>(0.9991f)), rnd<kBf16>(1e-4f));
  }
}

template <int kOp, bool kBf16>
__global__ void __launch_bounds__(kThreads)
unary_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int64_t numel, int n) {
  const int64_t e0 =
      (blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x) * kElems;
  if (e0 >= numel) return;
  const bool full = e0 + kElems <= numel;
  float a[kElems];
  if (full) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(x + e0));
    a[0] = t.x;
    a[1] = t.y;
    a[2] = t.z;
    a[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < kElems; ++j) a[j] = e0 + j < numel ? x[e0 + j] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kElems; ++j) a[j] = rnd<kBf16>(a[j]);

  int i = 0;
  // not unrolled further, so that one trip is kUnroll applications to each
  // element (what scripts/probe_exp.py --sass divides the loop's count by)
#pragma unroll 1
  for (; i + kUnroll <= n; i += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kElems; ++j) a[j] = apply<kOp, kBf16>(a[j]);
    }
  }
#pragma unroll 1
  for (; i < n; ++i) {
#pragma unroll
    for (int j = 0; j < kElems; ++j) a[j] = apply<kOp, kBf16>(a[j]);
  }

  if (full) {
    *reinterpret_cast<float4*>(out + e0) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kElems; ++j)
      if (e0 + j < numel) out[e0 + j] = a[j];
  }
}

template <int kOp, bool kBf16>
int launch(const float* x, float* out, int64_t numel, int n, cudaStream_t stream) {
  const int64_t threads = (numel + kElems - 1) / kElems;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  unary_chain_kernel<kOp, kBf16><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, out, numel, n);
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
