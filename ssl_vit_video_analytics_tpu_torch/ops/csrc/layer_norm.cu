// LayerNorm over the last dim for Hopper, sm_90a: bf16 or fp32 activations,
// fp32 weight and bias, fp32 statistics; forward, backward and the
// reduction of the weight and bias gradients.
//
// Replaces no TPU kernel: the JAX package leaves LayerNorm to XLA, which
// fuses flax's casts into it. It was added for the port's fp32 round trip:
// x.float(), torch's fp32 layer_norm and .to(bf16) moved about 20 bytes an
// element forward and, with their backward's casts, about 32 backward. This
// computes the same function in one pass each way: x is read in its own
// dtype and taken to fp32 (exact), the mean and variance are fp32, the
// affine is fp32, and y is rounded to its dtype once (round to nearest
// even, as torch's cast); the backward accumulates in fp32 and rounds dx to
// x's dtype once. In bf16 that is 4 bytes an element forward (x in, y out;
// the weight, bias and the row statistics are noise) and 6 backward (x and
// dy in, dx out).
//
// What bounds it: bytes. One H100 moves 3.35 TB/s; a row of 192 or 384
// elements is a few hundred FLOPs on 4-6 bytes an element, far under the
// 20 FLOP/byte the fp32 pipes need to be the limit. So the design is about
// keeping bytes in flight:
// - one warp a row, the row in registers: each lane holds NV chunks of VEC
//   elements, chunk i of lane l at columns (32 i + l) VEC, so a warp's
//   loads are contiguous. VEC is 16 bytes of x (8 bf16, 4 fp32) where the
//   width, the row stride and every pointer allow it (the wrapper checks),
//   else 1 (element by element, columns past D masked);
// - in the forward, where a lane holds at most 16 elements, a warp takes
//   two rows at once and issues both rows' loads before it reduces, so that
//   twice the bytes are in flight at the same occupancy (the backward holds
//   x, dy, the weight and two gradient sums a lane, and takes one);
// - mean and variance are two passes over the registers, not over memory,
//   each reduced by a butterfly of shuffles (every lane ends with the same
//   sum, bit for bit);
// - the forward grid covers the rows (8 warps a block); the backward grid
//   is persistent, as many blocks as are resident at once, each walking its
//   share of the rows, so that its fp32 weight and bias gradient sums stay
//   in registers over many rows and each block writes one partial sum a
//   column. A second kernel adds the partials per column in a fixed order:
//   the gradients are deterministic and no atomics are used.
// The forward allocates nothing and synchronizes nothing: the wrapper
// allocates y and the statistics, so a CUDA graph can capture the launch.
//
// x, y, dy and dx share one dtype; where a caller's x and y differ (no model
// of the port does that), the wrapper runs the fp32 kernels on the exact
// fp32 copy and rounds once after, the same function. Widths up to 1024
// (32 elements a lane); the wrapper raises above that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kReduceRows = 16;  // partials a reduction thread column adds

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N consecutive elements of T at p, as floats. N * sizeof(T) is 2, 4, 8, 16
// or 32 bytes, and p is aligned to the smaller of that and 16 bytes.
template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float (&v)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes >= 16) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < kPer; ++k) v[c * kPer + k] = to_float(e[k]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = to_float(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = to_float(p[k]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float (&v)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes >= 16) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int k = 0; k < kPer; ++k) e[k] = from_float<T>(v[c * kPer + k]);
      reinterpret_cast<uint4*>(p)[c] = raw;
    }
  } else if constexpr (kBytes == 8) {
    uint2 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < N; ++k) e[k] = from_float<T>(v[k]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = from_float<T>(v[k]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows a warp takes at once: two while a lane holds at most K = 16 elements
template <int K> constexpr int kRowsPerWarp = K <= 16 ? 2 : 1;

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, int64_t x_stride, const float* __restrict__ w,
              const float* __restrict__ b, T* __restrict__ y, float* __restrict__ mean_out,
              float* __restrict__ rstd_out, int64_t rows, int D, float eps) {
  constexpr int R = kRowsPerWarp<NV * VEC>;
  const int lane = threadIdx.x & 31;
  const int64_t row0 = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * R;
  if (row0 >= rows) return;
  float v[R][NV][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = (i * 32 + lane) * VEC;
      if (row0 + r < rows && col < D) {
        load<T, VEC>(x + (row0 + r) * x_stride + col, v[r][i]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[r][i][k] = 0.f;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t row = row0 + r;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int k = 0; k < VEC; ++k) s += v[r][i][k];
    const float mean = warp_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if ((i * 32 + lane) * VEC < D) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float d = v[r][i][k] - mean;
          q += d * d;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(q) / D + eps);
    if (row >= rows) break;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = (i * 32 + lane) * VEC;
      if (col < D) {
        float g[VEC], bb[VEC], o[VEC];
        load<float, VEC>(w + col, g);
        load<float, VEC>(b + col, bb);
#pragma unroll
        for (int k = 0; k < VEC; ++k) o[k] = (v[r][i][k] - mean) * rstd * g[k] + bb[k];
        store<T, VEC>(y + row * D + col, o);
      }
    }
    if (lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

// dx = rstd (g dy - mean_D(g dy) - xhat mean_D(g dy xhat)); the block's
// sums of dy xhat (weight) and dy (bias) over its rows, per column, go to
// partial[0][blockIdx.x] and partial[1][blockIdx.x].
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, int64_t x_stride, const T* __restrict__ dy,
              const float* __restrict__ w, const float* __restrict__ mean,
              const float* __restrict__ rstd, T* __restrict__ dx,
              float* __restrict__ partial, int64_t rows, int D) {
  constexpr int R = 1;  // x, dy and the gradient sums already fill the registers
  extern __shared__ float red[];  // [kWarps][D]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float g[NV][VEC], dw[NV][VEC], db[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (i * 32 + lane) * VEC;
    if (col < D) {
      load<float, VEC>(w + col, g[i]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) g[i][k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) dw[i][k] = db[i][k] = 0.f;
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps * R;
  for (int64_t row0 = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * R; row0 < rows;
       row0 += step) {
    float xv[R][NV][VEC], gv[R][NV][VEC], mu[R], rs[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t row = row0 + r;
      const bool live = row < rows;
      mu[r] = live ? mean[row] : 0.f;
      rs[r] = live ? rstd[row] : 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int col = (i * 32 + lane) * VEC;
        if (live && col < D) {
          load<T, VEC>(x + row * x_stride + col, xv[r][i]);
          load<T, VEC>(dy + row * D + col, gv[r][i]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) xv[r][i][k] = gv[r][i][k] = 0.f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float a = 0.f, c = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xhat = (xv[r][i][k] - mu[r]) * rs[r];  // masked: dy 0 adds nothing
          xv[r][i][k] = xhat;
          const float gd = gv[r][i][k] * g[i][k];
          a += gd;
          c += gd * xhat;
          dw[i][k] += gv[r][i][k] * xhat;
          db[i][k] += gv[r][i][k];
        }
      const float a_mean = warp_sum(a) / D, c_mean = warp_sum(c) / D;
      const int64_t row = row0 + r;
      if (row >= rows) break;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int col = (i * 32 + lane) * VEC;
        if (col < D) {
          float o[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            o[k] = (gv[r][i][k] * g[i][k] - a_mean - xv[r][i][k] * c_mean) * rs[r];
          store<T, VEC>(dx + row * D + col, o);
        }
      }
    }
  }
  // the block's sums, warp by warp in a fixed order
#pragma unroll
  for (int part = 0; part < 2; ++part) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = (i * 32 + lane) * VEC;
      if (col < D) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) red[warp * D + col + k] = part ? db[i][k] : dw[i][k];
      }
    }
    __syncthreads();
    float* out = partial + (static_cast<int64_t>(part) * gridDim.x + blockIdx.x) * D;
    for (int col = threadIdx.x; col < D; col += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kWarps; ++j) s += red[j * D + col];
      out[col] = s;
    }
    __syncthreads();
  }
}

// dweight, dbias [2][D] from partial [2][blocks][D]: block (32 columns x
// kReduceRows); each thread adds every kReduceRows-th partial of its
// column, then one thread a column adds those, in a fixed order.
__global__ void __launch_bounds__(32 * kReduceRows)
ln_bwd_reduce_kernel(const float* __restrict__ partial, int blocks, int D,
                     float* __restrict__ dwb) {
  __shared__ float s[kReduceRows][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const float* p = partial + static_cast<int64_t>(blockIdx.y) * blocks * D;
  float acc = 0.f;
  if (col < D) {
    for (int j = threadIdx.y; j < blocks; j += kReduceRows) acc += p[static_cast<int64_t>(j) * D + col];
  }
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < D) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < kReduceRows; ++j) t += s[j][threadIdx.x];
    dwb[blockIdx.y * D + col] = t;
  }
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

struct FwdArgs {
  const void* x; int64_t x_stride; const void* w; const void* b; void* y; void* mean;
  void* rstd; int64_t rows; int D; float eps; cudaStream_t stream;
};

struct BwdArgs {
  const void* x; int64_t x_stride; const void* dy; const void* w; const void* mean;
  const void* rstd; void* dx; void* partial; int grid; void* dwb; int64_t rows; int D;
  cudaStream_t stream; int* grid_out;  // set: report the grid, launch nothing
};

template <typename T, int VEC, int NV>
cudaError_t run_fwd(const FwdArgs& a) {
  constexpr int R = kRowsPerWarp<NV * VEC>;
  const int64_t blocks = cdiv(a.rows, static_cast<int64_t>(kWarps) * R);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  ln_fwd_kernel<T, VEC, NV><<<static_cast<unsigned>(blocks), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.x_stride, static_cast<const float*>(a.w),
      static_cast<const float*>(a.b), static_cast<T*>(a.y), static_cast<float*>(a.mean),
      static_cast<float*>(a.rstd), a.rows, a.D, a.eps);
  return cudaGetLastError();
}

template <typename T, int VEC, int NV>
cudaError_t run_bwd(const BwdArgs& a) {
  const size_t smem = sizeof(float) * kWarps * a.D;
  auto kernel = ln_bwd_kernel<T, VEC, NV>;
  if (a.grid_out != nullptr) {  // as many blocks as are resident at once
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    const int64_t need = cdiv(a.rows, kWarps);
    const int64_t most = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
    *a.grid_out = static_cast<int>(need < most ? need : most);
    return cudaSuccess;
  }
  if (a.grid < 1) return cudaErrorInvalidValue;
  kernel<<<a.grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), a.x_stride, static_cast<const T*>(a.dy),
      static_cast<const float*>(a.w), static_cast<const float*>(a.mean),
      static_cast<const float*>(a.rstd), static_cast<T*>(a.dx),
      static_cast<float*>(a.partial), a.rows, a.D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_reduce_kernel<<<dim3(static_cast<unsigned>(cdiv(a.D, 32)), 2),
                         dim3(32, kReduceRows), 0, a.stream>>>(
      static_cast<const float*>(a.partial), a.grid, a.D, static_cast<float*>(a.dwb));
  return cudaGetLastError();
}

struct Fwd {
  template <typename T, int VEC, int NV>
  static cudaError_t run(const FwdArgs& a) { return run_fwd<T, VEC, NV>(a); }
};
struct Bwd {
  template <typename T, int VEC, int NV>
  static cudaError_t run(const BwdArgs& a) { return run_bwd<T, VEC, NV>(a); }
};

// the least NV (chunks a lane) of the built ones that holds a row of D
template <class Op, typename T, typename Args>
cudaError_t by_width(bool vec, int D, const Args& a) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int need = static_cast<int>(cdiv(D, 32 * V));
    if (need <= 1) return Op::template run<T, V, 1>(a);
    if (need <= 2) return Op::template run<T, V, 2>(a);
    if constexpr (V == 8) {
      if (need <= 3) return Op::template run<T, V, 3>(a);
      if (need <= 4) return Op::template run<T, V, 4>(a);
    } else {
      if (need <= 4) return Op::template run<T, V, 4>(a);
      if (need <= 8) return Op::template run<T, V, 8>(a);
    }
    return cudaErrorInvalidValue;
  }
  // element by element: a width no multiple of 16 bytes, or a pointer or
  // row stride off them (rare: not on the models' paths)
  const int need = static_cast<int>(cdiv(D, 32));
  if (need <= 8) return Op::template run<T, 1, 8>(a);
  if (need <= 32) return Op::template run<T, 1, 32>(a);
  return cudaErrorInvalidValue;
}

// dtype codes: 0 fp32, 1 bf16
template <class Op, typename Args>
cudaError_t by_type(int dtype, bool vec, int D, const Args& a) {
  if (D < 1 || D > 1024) return cudaErrorInvalidValue;
  if (dtype == 1) return by_width<Op, __nv_bfloat16>(vec, D, a);
  if (dtype == 0) return by_width<Op, float>(vec, D, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// y [rows, D] (pitch D), mean and rstd [rows] fp32, from x [rows, D] at row
// pitch x_stride (elements), x and y in dtype; vec: 16-byte vectors (D,
// x_stride multiples of 16 bytes of x; x, w, b 16-byte aligned).
extern "C" int ssl_vit_layer_norm_fwd(int dtype, int vec, const void* x,
                                      int64_t x_stride, const void* w, const void* b, void* y,
                                      void* mean, void* rstd, int64_t rows, int D, float eps,
                                      void* stream) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{x, x_stride, w, b, y, mean, rstd, rows, D, eps,
                  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(by_type<Fwd>(dtype, vec != 0, D, a));
}

// The backward's grid (blocks, > 0) for these arguments, or minus a
// cudaError: the size of ssl_vit_layer_norm_bwd's partial buffer [2][grid][D].
extern "C" int ssl_vit_layer_norm_bwd_grid(int dtype, int vec, int64_t rows, int D) {
  if (rows < 1) return -static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  BwdArgs a{};
  a.rows = rows;
  a.D = D;
  a.grid_out = &grid;
  const cudaError_t err = by_type<Bwd>(dtype, vec != 0, D, a);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return grid;
}

// dx [rows, D] (pitch D) and dweight, dbias (dwb [2][D] fp32) from x (as
// the forward's), dy [rows, D] (pitch D), all three in dtype, and the
// forward's mean and rstd; partial: [2][grid][D] fp32 scratch, grid from
// ssl_vit_layer_norm_bwd_grid with the same arguments.
extern "C" int ssl_vit_layer_norm_bwd(int dtype, int vec, const void* x,
                                      int64_t x_stride, const void* dy, const void* w,
                                      const void* mean, const void* rstd, void* dx,
                                      void* partial, int grid, void* dwb, int64_t rows, int D,
                                      void* stream) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{x, x_stride, dy, w, mean, rstd, dx, partial, grid, dwb, rows, D,
                  static_cast<cudaStream_t>(stream), nullptr};
  return static_cast<int>(by_type<Bwd>(dtype, vec != 0, D, a));
}

extern "C" const char* ssl_vit_layer_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
