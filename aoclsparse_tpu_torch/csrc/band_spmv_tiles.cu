// Tile-major band SpMV for NVIDIA Hopper (sm_90a), two kernels of one
// contract over the (ntile, W, TM) tile-major band vt3 (kernels/band_tiles.py
// `band_tiles`: vt3[t, j, c] = vt[j, t * TM + c], zero past row m, where vt
// is the bandt form's (W, m) band, vt[j, i] = A[i, i + lo + j]):
//
//     y[i] = sum_{j < W} vt3[i / TM, j, i % TM] * x[start + i + j - padL]   (0 <= i < m)
//
// Terms whose x index falls outside [0, n) contribute 0, so no padded copy
// of x is made. The planner's peel spill is added by the wrapper after the
// launch.
//
// 1. band_spmv_tiles replaces aoclsparse_tpu/kernels/pallas/spmv.py:708
//    pallas_spmv_band_vc: one CTA per tile, whose W x TM slab is one
//    contiguous run of device memory.
// 2. band_spmv_tiles_dbuf replaces aoclsparse_tpu/kernels/pallas/spmv.py:791
//    pallas_spmv_band_vd, whose single grid step double-buffers the band's
//    tiles from HBM by manual DMA (spmv.py:740-787): here a persistent grid
//    of one CTA per SM walks tiles t = blockIdx.x + k * gridDim.x and stages
//    the band with cp.async into a two-deep shared-memory ring while it
//    computes on the stage before. A stage is a run of JC consecutive band
//    rows of one tile (JC = W when two whole slabs fit in shared memory,
//    else W split into near-equal chunks), contiguous in vt3. The tile's x
//    window is staged with the tile's first chunk, into its own two-deep
//    ring.
// The TPU layout of the Pallas kernels (the band pre-rotated into the
// output tile's (8, TM/8) sublane distribution, band_vert_layout_tiles,
// spmv.py:666) stays behind: Hopper reads the plain row of a tile
// coalesced.
//
// What bounds them: the band is W * m values read once, against m + W
// values of x and m of y; at the bench operand (m = 262144, W = 128) that
// is 134 MB of f32 band (67 MB as bf16) at 2 flops a band value, far below
// the card's flop:byte balance. Device-memory bandwidth bounds both, so
// each aims to read every band value once, in full transactions, with
// enough bytes in flight: kernel 1 through many CTAs with eight unrolled
// loads a thread, kernel 2 through a stage of up to JC * TM values in
// flight on every SM while the last stage is summed from shared memory.
//
// Both sum j in increasing order in float32; a bf16 band is widened per
// value (__bfloat162float) and x stays float32.
//
// Instances (plain C entry points, bound with ctypes):
//   band_spmv_tiles_f32,      band_spmv_tiles_bf16
//   band_spmv_tiles_dbuf_f32, band_spmv_tiles_dbuf_bf16
// Each launches on the given stream, does not synchronise, allocates
// nothing, and returns the CUDA error of the attribute call or the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxR = 8;          // dbuf: at most 8 rows a thread (TM <= 2048)
constexpr int kMaxSmem = 232448;  // sm_90a: dynamic shared memory of one CTA

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// kernel 1: one CTA per tile, thread tid owns rows tid, tid + 256, ... of it
template <typename VT>
__global__ void __launch_bounds__(kThreads)
band_tiles_kernel(const VT* __restrict__ vt3, const float* __restrict__ x, float* __restrict__ y,
                  int64_t m, int64_t n, int W, int TM, int64_t start, int64_t padL) {
  extern __shared__ __align__(16) unsigned char tiles_smem[];
  float* xs = reinterpret_cast<float*>(tiles_smem);  // TM + W - 1 values
  const int64_t t = blockIdx.x;
  const int64_t row0 = t * TM;
  const int64_t xbase = start + row0 - padL;  // x index held by xs[0]
  const int span = TM + W - 1;
  for (int e = threadIdx.x; e < span; e += kThreads) {
    const int64_t k = xbase + e;
    xs[e] = (k >= 0 && k < n) ? x[k] : 0.0f;
  }
  __syncthreads();
  const VT* slab = vt3 + t * static_cast<int64_t>(W) * TM;
  for (int c = threadIdx.x; c < TM && row0 + c < m; c += kThreads) {
    const VT* p = slab + c;
    const float* xw = xs + c;
    float acc = 0.0f;
#pragma unroll 8
    for (int j = 0; j < W; ++j) acc = fmaf(widen(p[static_cast<int64_t>(j) * TM]), xw[j], acc);
    y[row0 + c] = acc;
  }
}

// kernel 2: persistent; chunk q of this CTA is band rows [jc * JC, +JC) of
// its tile number q / nchunk (tile blockIdx.x + (q / nchunk) * gridDim.x)
template <typename VT>
__global__ void __launch_bounds__(kThreads)
band_tiles_dbuf_kernel(const VT* __restrict__ vt3, const float* __restrict__ x, float* __restrict__ y,
                       int64_t m, int64_t n, int W, int TM, int JC, int64_t ntile, int64_t start,
                       int64_t padL) {
  extern __shared__ __align__(16) unsigned char dbuf_smem[];
  const int span = TM + W - 1;
  const int span16 = (span + 3) / 4 * 4;  // keep the band stages 16-byte aligned
  float* xs = reinterpret_cast<float*>(dbuf_smem);                   // 2 x span16 values
  VT* vs = reinterpret_cast<VT*>(dbuf_smem + 2 * span16 * sizeof(float));  // 2 x JC * TM values
  const int64_t stage = static_cast<int64_t>(JC) * TM;
  const int nchunk = (W + JC - 1) / JC;
  const int64_t my_tiles = blockIdx.x < ntile ? (ntile - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t nq = my_tiles * nchunk;
  const int vec = 16 / static_cast<int>(sizeof(VT));  // values a 16-byte copy moves

  // stage chunk q into ring slot q % 2 (and, on a tile's first chunk, its
  // x window into x slot (q / nchunk) % 2)
  auto issue = [&](int64_t q) {
    const int64_t lt = q / nchunk;
    const int jc = static_cast<int>(q - lt * nchunk);
    const int64_t t = blockIdx.x + lt * gridDim.x;
    const int j0 = jc * JC;
    const int rows = min(JC, W - j0);
    const VT* src = vt3 + (t * W + j0) * static_cast<int64_t>(TM);
    VT* dst = vs + (q & 1) * stage;
    const int nv = rows * TM / vec;  // TM * sizeof(VT) is a multiple of 16
    for (int e = threadIdx.x; e < nv; e += kThreads) cp_async16(dst + e * vec, src + e * vec);
    if (jc == 0) {
      float* xw = xs + (lt & 1) * span16;
      const int64_t xbase = start + t * TM - padL;
      for (int e = threadIdx.x; e < span; e += kThreads) {
        const int64_t k = xbase + e;
        if (k >= 0 && k < n) {
          cp_async4(xw + e, x + k);
        } else {
          xw[e] = 0.0f;
        }
      }
    }
  };

  float acc[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) acc[r] = 0.0f;
  if (nq > 0) issue(0);
  cp_async_commit();
  for (int64_t q = 0; q < nq; ++q) {
    if (q + 1 < nq) issue(q + 1);  // its slot was last read in chunk q - 1
    cp_async_commit();
    cp_async_wait1();  // chunk q has landed
    __syncthreads();
    const int64_t lt = q / nchunk;
    const int jc = static_cast<int>(q - lt * nchunk);
    const int64_t row0 = (blockIdx.x + lt * gridDim.x) * TM;
    const int j0 = jc * JC;
    const int rows = min(JC, W - j0);
    const VT* band = vs + (q & 1) * stage;
    const float* xw = xs + (lt & 1) * span16 + j0;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      const int c = threadIdx.x + r * kThreads;
      if (c < TM) {
        float a = acc[r];
#pragma unroll 8
        for (int jj = 0; jj < rows; ++jj) a = fmaf(widen(band[jj * TM + c]), xw[c + jj], a);
        acc[r] = a;
      }
    }
    if (jc == nchunk - 1) {
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        const int c = threadIdx.x + r * kThreads;
        if (c < TM && row0 + c < m) y[row0 + c] = acc[r];
        acc[r] = 0.0f;
      }
    }
    __syncthreads();  // slot q % 2 is free for chunk q + 2
  }
}

template <typename VT>
int launch_tiles(const void* vt3, const void* x, void* y, int64_t m, int64_t n, int64_t W, int64_t TM,
                 int64_t start, int64_t padL, void* stream) {
  if (m <= 0) return 0;
  const int64_t ntile = (m + TM - 1) / TM;
  const size_t smem = static_cast<size_t>(TM + W - 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(band_tiles_kernel<VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  band_tiles_kernel<VT><<<static_cast<unsigned>(ntile), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const VT*>(vt3), static_cast<const float*>(x), static_cast<float*>(y), m, n,
      static_cast<int>(W), static_cast<int>(TM), start, padL);
  return static_cast<int>(cudaGetLastError());
}

template <typename VT>
int launch_dbuf(const void* vt3, const void* x, void* y, int64_t m, int64_t n, int64_t W, int64_t TM,
                int64_t start, int64_t padL, void* stream) {
  if (m <= 0) return 0;
  if (TM > kThreads * kMaxR || (TM * static_cast<int64_t>(sizeof(VT))) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t ntile = (m + TM - 1) / TM;
  const int64_t span16 = (TM + W - 1 + 3) / 4 * 4;
  const int64_t xbytes = 2 * span16 * static_cast<int64_t>(sizeof(float));
  const int64_t row_bytes = TM * static_cast<int64_t>(sizeof(VT));
  const int64_t jc_max = (kMaxSmem - xbytes) / (2 * row_bytes);
  if (jc_max < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nchunk = (W + jc_max - 1) / jc_max;
  const int64_t JC = (W + nchunk - 1) / nchunk;  // near-equal chunks
  const size_t smem = static_cast<size_t>(xbytes + 2 * JC * row_bytes);
  cudaError_t err = cudaFuncSetAttribute(band_tiles_dbuf_kernel<VT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = ntile < sms ? ntile : sms;
  band_tiles_dbuf_kernel<VT><<<static_cast<unsigned>(grid), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const VT*>(vt3), static_cast<const float*>(x), static_cast<float*>(y), m, n,
      static_cast<int>(W), static_cast<int>(TM), static_cast<int>(JC), ntile, start, padL);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int band_spmv_tiles_f32(const void* vt3, const void* x, void* y, int64_t m, int64_t n, int64_t W, int64_t TM,
                        int64_t start, int64_t padL, void* stream) {
  return launch_tiles<float>(vt3, x, y, m, n, W, TM, start, padL, stream);
}

int band_spmv_tiles_bf16(const void* vt3, const void* x, void* y, int64_t m, int64_t n, int64_t W, int64_t TM,
                         int64_t start, int64_t padL, void* stream) {
  return launch_tiles<__nv_bfloat16>(vt3, x, y, m, n, W, TM, start, padL, stream);
}

int band_spmv_tiles_dbuf_f32(const void* vt3, const void* x, void* y, int64_t m, int64_t n, int64_t W,
                             int64_t TM, int64_t start, int64_t padL, void* stream) {
  return launch_dbuf<float>(vt3, x, y, m, n, W, TM, start, padL, stream);
}

int band_spmv_tiles_dbuf_bf16(const void* vt3, const void* x, void* y, int64_t m, int64_t n, int64_t W,
                              int64_t TM, int64_t start, int64_t padL, void* stream) {
  return launch_dbuf<__nv_bfloat16>(vt3, x, y, m, n, W, TM, start, padL, stream);
}

}  // extern "C"
