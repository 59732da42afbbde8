// 3x3 depthwise convolution (P1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `dw_roll_kernel`, launched by `dw_roll` in
// scripts/probe_dw.py. It computes the same thing: for x [N, H*W, C]
// (channels contiguous, one image's pixels in row-major order) and taps
// w [9, C] in fp32,
//   out[n, h*W+w, c] = sum over dh, dw in {-1, 0, 1} of
//                      x[n, (h+dh)*W + (w+dw), c] * w[(dh+1)*3 + (dw+1), c],
// zero outside the image (SAME cross-correlation), accumulated in fp32 in
// that (dh, dw) order and stored in x's dtype (fp32 or bf16).
//
// Design, for the card rather than carried over from the TPU: the TPU
// kernel rolled a whole image along its sublanes and killed the wrapped
// rows with modulo-iota masks, G images per grid cell; that is VMEM/VPU
// tiling. Here one thread owns one 16-byte vector of channels (8 bf16 or 4
// fp32) of one output pixel. Neighbouring threads of a warp own
// neighbouring vectors of the same pixel, so every load is one coalesced
// 16-byte access. The nine neighbours are read with explicit edge tests
// (no zero-padded copy of x); taps are read as float4.
//
// What bounds it: HBM bytes. Each element is read once and written once,
// and the 9 taps are 18 flops per element. At the probe's shape (N = 256,
// 56x56 pixels, C = 384, bf16) that is 2 x 616.6 MB, or 0.368 ms at
// 3.35 TB/s, against 0.083 ms of fp32 FMA work at 67 TFLOP/s (H100 SXM
// data-sheet rates). A neighbour row is re-read by the threads of the rows
// above and below while it is still in L2 (an image row is 43 KB in bf16),
// so device-memory traffic stays near the 2x minimum; the price of this
// simple version is nine 16-byte loads per output vector through L1/L2.
// Keeping a sliding 3x3 window in registers along a column of pixels would
// cut those loads threefold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// 16 bytes of x as V floats
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 t;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = t;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
dw3x3_kernel(const T* __restrict__ x, const float* __restrict__ w,
             T* __restrict__ out, int H, int W, int CV, int64_t total) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= total) return;
  const int cv = static_cast<int>(i % CV);
  const int64_t p = i / CV;  // pixel n*H*W + h*W + w
  const int col = static_cast<int>(p % W);
  const int row = static_cast<int>((p / W) % H);
  const int64_t C = static_cast<int64_t>(CV) * V;

  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll
  for (int dh = -1; dh <= 1; ++dh) {
    if (row + dh < 0 || row + dh >= H) continue;
#pragma unroll
    for (int dw = -1; dw <= 1; ++dw) {
      if (col + dw < 0 || col + dw >= W) continue;
      float xv[V], tap[V];
      load_vec(x + (p + dh * W + dw) * C + cv * V, xv);
      const float* wp = w + ((dh + 1) * 3 + (dw + 1)) * C + cv * V;
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        float t4[4];
        load_vec(wp + j, t4);
#pragma unroll
        for (int k = 0; k < 4; ++k) tap[j + k] = t4[k];
      }
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(xv[j], tap[j], acc[j]);
    }
  }
  store_vec(out + p * C + cv * V, acc);
}

template <typename T, int V>
int launch(const void* x, const float* w, void* out, int N, int H, int W, int C,
           cudaStream_t stream) {
  const int CV = C / V;
  const int64_t total = static_cast<int64_t>(N) * H * W * CV;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  dw3x3_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), H, W, CV, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// x and out are contiguous [N, H*W, C], w contiguous fp32 [9, C]; all three
// 16-byte aligned and C a multiple of 16 bytes' worth of x's dtype (the
// wrapper checks). Returns the launch's cudaError_t (0 = success).
extern "C" int ssl_vit_dw3x3(int dtype, const void* x, const void* w, void* out,
                             int N, int H, int W, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0) return launch<float, 4>(x, wf, out, N, H, W, C, s);
  if (dtype == 1) return launch<__nv_bfloat16, 8>(x, wf, out, N, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssl_vit_dw3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
