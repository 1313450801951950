// Band SpMV for NVIDIA Hopper (sm_90a), the mv kernel of the `bandt`
// execution form:
//
//     y[i] = sum_{j < W} vt[j, i] * x[start + i + j - padL]     (0 <= i < m)
//
// over the plain transposed (W, m) band `vt` (ExecForm.bwd_val,
// vt[j, i] = A[i, i + lo + j]); terms whose x index falls outside [0, n)
// contribute 0. The planner's peel spill is not part of the kernel: the
// wrapper adds it after the launch, on the same stream
// (aoclsparse_tpu_torch/kernels/band_spmv.py).
//
// Replaces three TPU kernels of the JAX package, all one product:
//   aoclsparse_tpu/kernels/pallas/spmv.py:531  pallas_spmv_band_t    (mv KID 8)
//   aoclsparse_tpu/kernels/pallas/spmv.py:626  pallas_spmv_band_v    (mv KID 12)
//   aoclsparse_tpu/kernels/pallas/spmv.py:899  pallas_spmv_band_v_df (mv KID 13)
// The TPU's sublane layout of the band, its tile picking and the
// double-float arithmetic of KID 13 have no counterpart here: Hopper reads
// the plain (W, m) band coalesced, and has native f64.
//
// What bounds it: the band is W * m values streamed once, against m + W
// values of x and m of y. At W = 128 and m = 262144 that is 134 MB of f32
// band (67 MB as bf16) against about 2 MB of x and y, at 2 flops per band
// value, far below the card's flop:byte balance. So device-memory bandwidth
// bounds the kernel, and its design has one aim: read every band value once,
// in full 128-byte transactions, with enough loads in flight.
//
// Design: one thread per output row, kRows rows per block. The block first
// stages its x window (kRows + W - 1 values, zero outside [0, n)) in shared
// memory; thread t of the block then walks j = 0..W-1 reading vt[j, row0+t],
// so a warp reads 32 consecutive band values per j (128 bytes in f32) and
// x[j + t] from shared memory without bank conflicts. The j loop is unrolled
// so each thread keeps several independent band loads in flight. The sum is
// kept in float32 (float64 for the f64 instance) and sums j in increasing
// order. With W <= 1024 the x window is at most 10 KB, under the 48 KB of
// static shared memory, so no opt-in attribute is needed.
//
// Instances (plain C entry points, bound with ctypes):
//   band_spmv_f32  : band f32,  x f32, accumulate f32
//   band_spmv_bf16 : band bf16, x f32, accumulate f32 (__bfloat162float only)
//   band_spmv_f64  : band f64,  x f64, accumulate f64
// Each launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 256;  // output rows (threads) per block

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }

template <typename VT, typename T>
__global__ void __launch_bounds__(kRows)
band_spmv_kernel(const VT* __restrict__ vt, const T* __restrict__ x, T* __restrict__ y,
                 int64_t m, int64_t n, int W, int64_t start, int64_t padL) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int64_t xbase = start + row0 - padL;  // x index held by xs[0]
  const int span = kRows + W - 1;
  for (int t = threadIdx.x; t < span; t += kRows) {
    const int64_t k = xbase + t;
    xs[t] = (k >= 0 && k < n) ? x[k] : static_cast<T>(0);
  }
  __syncthreads();

  const int64_t i = row0 + threadIdx.x;
  if (i >= m) return;
  const VT* p = vt + i;
  const T* xw = xs + threadIdx.x;
  T acc = static_cast<T>(0);
#pragma unroll 8
  for (int j = 0; j < W; ++j) {
    acc = mul_add(widen(p[static_cast<int64_t>(j) * m]), xw[j], acc);
  }
  y[i] = acc;
}

template <typename VT, typename T>
int launch(const void* vt, const void* x, void* y, int64_t m, int64_t n, int64_t W,
           int64_t start, int64_t padL, void* stream) {
  if (m <= 0) return 0;
  const int64_t blocks = (m + kRows - 1) / kRows;
  const size_t smem = static_cast<size_t>(kRows + W - 1) * sizeof(T);
  band_spmv_kernel<VT, T><<<static_cast<unsigned>(blocks), kRows, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const VT*>(vt), static_cast<const T*>(x), static_cast<T*>(y), m, n,
      static_cast<int>(W), start, padL);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int band_spmv_f32(const void* vt, const void* x, void* y, int64_t m, int64_t n, int64_t W,
                  int64_t start, int64_t padL, void* stream) {
  return launch<float, float>(vt, x, y, m, n, W, start, padL, stream);
}

int band_spmv_bf16(const void* vt, const void* x, void* y, int64_t m, int64_t n, int64_t W,
                   int64_t start, int64_t padL, void* stream) {
  return launch<__nv_bfloat16, float>(vt, x, y, m, n, W, start, padL, stream);
}

int band_spmv_f64(const void* vt, const void* x, void* y, int64_t m, int64_t n, int64_t W,
                  int64_t start, int64_t padL, void* stream) {
  return launch<double, double>(vt, x, y, m, n, W, start, padL, stream);
}

}  // extern "C"
