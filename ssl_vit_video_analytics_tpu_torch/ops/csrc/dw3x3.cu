// 3x3 depthwise convolution (P1) for Hopper, sm_90a: shared-memory tiles
// filled by the Tensor Memory Accelerator (TMA).
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
// What bounds it: HBM bytes. Each element is read once and written once,
// and the 9 taps are 18 flops per element. At the probe's shape (N = 256,
// 56x56 pixels, C = 384, bf16) that is 2 x 616.6 MB, or 0.368 ms at
// 3.35 TB/s, against 0.083 ms of fp32 FMA work at 67 TFLOP/s (H100 SXM
// data-sheet rates).
//
// Design, for the card rather than carried over from the TPU (which rolled
// a whole image along its sublanes and masked the wrapped rows):
// - x is a 4-D tensor map [N, H, W, C] (C innermost). A tile is TH output
//   rows x BW output columns x CC channels; the TMA copies it with its
//   one-pixel halo, box (CC, BW+2, TH+2, 1) at (c0, w0-1, h0-1, n), into
//   shared memory, and completes on an mbarrier. Its out-of-bounds zero fill
//   is the SAME padding: no edge tests, no padded copy of x. Rows, columns
//   and channels past the edge are zero on load and not stored.
// - A persistent grid (as many CTAs as fit on the card) walks the tiles
//   through a ring of 2 slots, so the TMA fills the next tile while the
//   CTA computes this one. Tiles are numbered channel chunk fastest, then
//   column tile, row band, image: CTAs that run together hold neighbouring
//   bands of one image, whose shared halo rows the second reads from L2.
// - Each thread owns one 16-byte channel vector (8 bf16 or 4 fp32) of one
//   column of the tile and walks down it: every input row is read from
//   shared memory once (3 vectors: w-1, w, w+1) and added into the three
//   output rows it touches (as dh = -1, 0, +1), so each output costs 3
//   shared-memory reads, not 9, and still sums its taps in (dh, dw) order.
//   Its 9 x V taps stay in registers across tiles of one channel chunk.
// - Outputs go straight from registers to device memory as 16-byte stores;
//   a warp writes 128-byte runs of channels.
// The tile is fixed at TH = 8 rows and CC = 64 bytes of channels (32 bf16
// or 16 fp32) in a ring of 2 slots: the fastest of the tiles timed on an
// H100 (4, 8 or 16 rows, 64 or 128 bytes, 2 to 4 slots; PERF.md §6). Only
// the column tile and the block size follow the image: BW is the whole
// width where the box (BW + 2 <= 256) and a slot allow, else the width cut
// into equal column tiles; a thread for each 16-byte vector of a tile row,
// at most 256.
//
// The tensor-map encoder, cuTensorMapEncodeTiled, lives in libcuda; the
// runtime hands out its address, so this library does not link libcuda.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if CUDART_VERSION < 12050
#error "dw3x3.cu needs CUDA 12.5 or later (cudaGetDriverEntryPointByVersion)"
#endif

namespace {

constexpr int TH = 8;             // output rows of a tile
constexpr int kChunkBytes = 64;   // channels of a tile, in bytes
constexpr int kStages = 2;        // ring slots
constexpr int kVectorBytes = 16;  // one thread's channels of one pixel
constexpr int kMaxThreads = 256;
constexpr int kMaxBox = 256;  // the TMA's largest box extent
// one slot of the ring, in 128-byte units: the ring, its barriers and the
// alignment pad fit a CTA's 227 KB of shared memory
constexpr int kMaxSlotBytes = (227 * 1024 - 256) / kStages / 128 * 128;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the tiling of one call
struct Tiles {
  int N, H, W, C;
  int BW, CC;                 // output columns and channels of a tile
  int n_chunk, n_col, n_band; // channel chunks, column tiles, row bands
  int tiles;
  int stage_bytes;            // one ring slot (the box, rounded up to 128 bytes)
  int box_bytes;              // what the TMA writes into a slot
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one thread: expect the box's bytes on `bar`, then start the TMA copy
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         uint32_t bytes, int c, int w, int h, int n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n)
      : "memory");
}

// 16 bytes of a tile in shared memory as V floats (bf16 widened by a shift)
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
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

struct Origin {
  int c0, w0, h0, n;
};

__device__ __forceinline__ Origin origin(int t, const Tiles& p) {
  Origin o;
  o.c0 = (t % p.n_chunk) * p.CC;
  t /= p.n_chunk;
  o.w0 = (t % p.n_col) * p.BW;
  t /= p.n_col;
  o.h0 = (t % p.n_band) * TH;
  o.n = t / p.n_band;
  return o;
}

__device__ __forceinline__ void issue(int t, const Tiles& p, const CUtensorMap* map,
                                      uint32_t slot, uint32_t bar) {
  const Origin o = origin(t, p);
  tma_load(slot, map, bar, p.box_bytes, o.c0, o.w0 - 1, o.h0 - 1, o.n);
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads, 1)
dw3x3_tma_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ w,
                 T* __restrict__ out, const Tiles p) {
  extern __shared__ unsigned char smem_raw[];
  // the ring at a 128-byte boundary (the TMA's destination), then its barriers
  unsigned char* ring = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kStages * p.stage_bytes);
  const int tid = threadIdx.x;
  const int first = blockIdx.x;
  const int G = gridDim.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&bars[s]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kStages; ++s)
      if (first + s * G < p.tiles)
        issue(first + s * G, p, &xmap, smem_u32(ring + s * p.stage_bytes), smem_u32(&bars[s]));
  }
  __syncthreads();

  const int vpc = p.CC / V;  // 16-byte vectors per pixel of a tile
  const int items = p.BW * vpc;
  const int row = (p.BW + 2) * p.CC;  // elements per tile row
  float tap[9][V];
  int tap_c = -1;
  int s = 0, phase = 0;  // this tile's slot, and the parity of its fill
  for (int t = first; t < p.tiles; t += G) {
    const Origin o = origin(t, p);
    mbar_wait(smem_u32(&bars[s]), phase);
    const T* tile = reinterpret_cast<const T*>(ring + s * p.stage_bytes);
    for (int i = tid; i < items; i += blockDim.x) {
      const int col = i / vpc;
      const int c = o.c0 + (i - col * vpc) * V;
      const int wc = o.w0 + col;
      if (c >= p.C || wc >= p.W) continue;
      if (c != tap_c) {
#pragma unroll
        for (int q = 0; q < 9; ++q)
#pragma unroll
          for (int j = 0; j < V; j += 4) {
            const float4 t4 = __ldg(reinterpret_cast<const float4*>(w + q * p.C + c + j));
            tap[q][j] = t4.x;
            tap[q][j + 1] = t4.y;
            tap[q][j + 2] = t4.z;
            tap[q][j + 3] = t4.w;
          }
        tap_c = c;
      }
      // tile row r is image row h0-1+r; tile column col+dw is image column wc-1+dw
      const T* src = tile + col * p.CC + (c - o.c0);
      T* dst = out + ((static_cast<int64_t>(o.n) * p.H + o.h0) * p.W + wc) * p.C + c;
      float acc[TH][V];
#pragma unroll
      for (int r = 0; r < TH + 2; ++r) {
        float xv[3][V];
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) load_vec(src + r * row + dw * p.CC, xv[dw]);
        // input row r is row dh = -1 of output row r, dh = 0 of r-1, dh = +1 of r-2
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          const int orow = r - dh;
          if (orow < 0 || orow >= TH) continue;
          if (dh == 0) {
#pragma unroll
            for (int j = 0; j < V; ++j) acc[orow][j] = 0.f;
          }
#pragma unroll
          for (int dw = 0; dw < 3; ++dw)
#pragma unroll
            for (int j = 0; j < V; ++j)
              acc[orow][j] = fmaf(xv[dw][j], tap[dh * 3 + dw][j], acc[orow][j]);
        }
        const int done = r - 2;  // its three rows are in
        if (done >= 0 && o.h0 + done < p.H)
          store_vec(dst + static_cast<int64_t>(done) * p.W * p.C, acc[done]);
      }
    }
    __syncthreads();  // every thread is done with slot s: refill it
    if (tid == 0 && t + kStages * G < p.tiles)
      issue(t + kStages * G, p, &xmap, smem_u32(ring + s * p.stage_bytes), smem_u32(&bars[s]));
    if (++s == kStages) s = 0, phase ^= 1;
  }
}

EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                           12000, cudaEnableDefault, &found);
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// the tiling of [N, H, W, C] images of elements of es bytes (C a multiple of
// a 16-byte vector), and the threads of a CTA; false where the tiles
// outnumber an int
bool plan(int N, int H, int W, int C, int es, Tiles& p, int& threads) {
  p.N = N;
  p.H = H;
  p.W = W;
  p.C = C;
  p.CC = kChunkBytes / es;
  // the widest column tile whose box (with its halo) fits the TMA and a slot
  const int slot_cols = kMaxSlotBytes / ((TH + 2) * kChunkBytes);
  const int widest = (slot_cols < kMaxBox ? slot_cols : kMaxBox) - 2;
  p.n_col = ceil_div(W, widest);
  p.BW = ceil_div(W, p.n_col);
  p.n_chunk = ceil_div(C, p.CC);
  p.n_band = ceil_div(H, TH);
  const int64_t tiles = static_cast<int64_t>(p.n_chunk) * p.n_col * p.n_band * N;
  if (tiles > 0x7fffffff) return false;
  p.tiles = static_cast<int>(tiles);
  p.box_bytes = (TH + 2) * (p.BW + 2) * kChunkBytes;
  p.stage_bytes = ceil_div(p.box_bytes, 128) * 128;
  const int items = p.BW * (kChunkBytes / kVectorBytes);  // 16-byte vectors of a tile row
  threads = 32 * ceil_div(items, 32);
  if (threads > kMaxThreads) threads = kMaxThreads;
  return true;
}

template <typename T, int V>
int launch(const void* x, const float* w, void* out, const Tiles& p, int threads,
           CUtensorMapDataType type, cudaStream_t stream) {
  const EncodeTiledFn encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.C), static_cast<cuuint64_t>(p.W),
                              static_cast<cuuint64_t>(p.H), static_cast<cuuint64_t>(p.N)};
  const cuuint64_t strides[3] = {dims[0] * es, dims[0] * dims[1] * es,
                                 dims[0] * dims[1] * dims[2] * es};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(p.CC), static_cast<cuuint32_t>(p.BW + 2),
                             static_cast<cuuint32_t>(TH + 2), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUtensorMap map;
  if (encode(&map, type, 4, const_cast<void*>(x), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  auto kernel = dw3x3_tma_kernel<T, V>;
  const int smem = kStages * (p.stage_bytes + 8) + 128;  // + barriers, + alignment
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = p.tiles < sms * per_sm ? p.tiles : sms * per_sm;
  kernel<<<grid, threads, smem, stream>>>(map, w, static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// x and out are contiguous [N, H*W, C], w contiguous fp32 [9, C]; all three
// 16-byte aligned and C a multiple of 16 bytes' worth of x's dtype (the
// wrapper checks). Returns the launch's cudaError_t (0 = success;
// cudaErrorInvalidValue for a shape it does not take or a tensor map
// libcuda refuses).
extern "C" int ssl_vit_dw3x3(int dtype, const void* x, const void* w, void* out, int N, int H,
                             int W, int C, void* stream) {
  const int es = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  Tiles p;
  int threads = 0;
  if (es == 0 || N < 1 || H < 1 || W < 1 || C < 1 || (C * es) % kVectorBytes ||
      !plan(N, H, W, C, es, p, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0)
    return launch<float, 4>(x, wf, out, p, threads, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, s);
  return launch<__nv_bfloat16, 8>(x, wf, out, p, threads, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, s);
}

extern "C" const char* ssl_vit_dw3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
