// Band SpMM for NVIDIA Hopper (sm_90a): the two mm kernels of the `bandtm`
// execution form, a row-aligned (m, W) band times a dense row-major RHS.
//
// 1. spmm_band (mm KID 4), over the band itself (ExecForm.bwd_val,
//    v[i, j] = A[i, i + lo + j]):
//
//      C[i, :] = sum_{j < W} v[i, j] * B[start + i + j - padL, :]     (0 <= i < m)
//
//    Replaces aoclsparse_tpu/kernels/pallas/spmv.py:173 pallas_spmm_band_t
//    (and its wrapper spmm_bandtm, :220).
//
// 2. spmm_band_mxu (mm KID 5), over the block-window form of the same band
//    (ExecForm.band_mxu_dt, dt[k, c, s] = v[128k + s, c - s] for
//    0 <= c - s < W, W <= 129):
//
//      C[128k + s, :] = sum_{c < 256} dt[k, c, s] * B[start + 128k + c - padL, :]
//
//    Replaces aoclsparse_tpu/kernels/pallas/spmv.py:306 pallas_spmm_band_mxu
//    (and its wrapper spmm_bandmxu, :253).
//
// B rows outside [0, n) and columns past K contribute 0: the padL left
// padding and the ragged edges are index arithmetic here, so no padded copy
// of B is ever made. The peel spill is added by the wrapper after the
// launch (aoclsparse_tpu_torch/kernels/spmm_band.py). The TPU machinery of
// the Pallas kernels (eight pltpu.roll pre-rotated window copies, the lane
// padding of K and W to 128, VMEM-driven tile sizes) has no counterpart.
//
// What bounds them, at the bench operand (m = 262144, W = 128, K = 64, f32):
//   spmm_band: 134.2 MB of band + 67.1 MB of B + 67.1 MB of C = 268 MB at
//   3350 GB/s = 0.080 ms; 2.15 G FMA at 33.5 T FMA/s (67 TFLOP/s f32) =
//   0.064 ms. Bytes and FMAs are close, so the design reads B from device
//   memory about (TM + W - 1) / TM times, not W times, and keeps the FMA
//   loop fed from registers and shared memory.
//   spmm_band_mxu: 268.4 MB of dt (twice the band: the zero triangle of
//   each 256-row window is streamed) + 134.2 MB of B and C = 0.120 ms;
//   4.3 G FMA = 0.128 ms, so about 0.13 ms. It computes the full 256-deep
//   window product as the TPU's matrix unit did. The JAX package pins it to
//   HIGHEST precision in f32 (spmv.py:289), so the f32 instance is plain
//   f32 FMA, never TF32; the bf16 instance rounds the B window to bf16
//   before the product (spmv.py:292) and accumulates in f32.
//
// Design, spmm_band: a CTA of 256 threads owns a tile of kTM = 64 rows and
// kKC = 64 RHS columns. It stages the tile's band rows (contiguous in v)
// and the B rows [start + i0 - padL, + kTM + W - 1) of its column chunk in
// dynamic shared memory once. Thread (ty, tx) owns rows 4ty..4ty+3 and
// columns tx + 16q, q < 4: a register window of four B rows slides down by
// one row per j, so each j costs one new B row (4 values) and four band
// values from shared memory for 16 FMAs. Sums run over j in increasing
// order in the operand dtype. The B window's row stride kKCS = kKC + 4
// keeps the two row groups of a warp on distinct banks.
//
// Design, spmm_band_mxu: a CTA of 256 threads owns one 128-row block and
// kKC = 64 columns. It walks the 256 window rows in slices of kCS = 32,
// staging dt[k, c-slice, :] (contiguous) and the matching B rows in shared
// memory; thread (ty, tx) owns rows 8ty..8ty+7 and columns tx + 16q, 32
// outputs from 12 shared loads per window row.
//
// Instances (plain C entry points, bound with ctypes):
//   spmm_band_f32      : v f32, B f32, C f32 (f32 accumulation)
//   spmm_band_f64      : v f64, B f64, C f64
//   spmm_band_mxu_f32  : dt f32, B f32, C f32
//   spmm_band_mxu_bf16 : dt bf16, B f32 rounded to bf16, C f32
// Each launches on the given stream, does not synchronise, allocates
// nothing, and returns the CUDA error of the attribute call or the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 64;        // spmm_band: rows per CTA (16 groups of 4)
constexpr int kKC = 64;        // RHS columns per CTA (16 lanes x 4)
constexpr int kKCS = kKC + 4;  // shared row stride of a staged B row
constexpr int kMB = 128;       // spmm_band_mxu: rows per block
constexpr int kWB = 256;       // window rows per block
constexpr int kCS = 32;        // window rows staged per slice

__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// the B window in the dt dtype: f32 stays, bf16 rounds to nearest even
__device__ __forceinline__ float round_b(float b, float) { return b; }
__device__ __forceinline__ float round_b(float b, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(b));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spmm_band_kernel(const T* __restrict__ v, const T* __restrict__ B, T* __restrict__ C, int64_t m,
                 int64_t n, int64_t K, int W, int64_t start, int64_t padL) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  T* bs = reinterpret_cast<T*>(band_smem);  // (kTM + W - 1) x kKCS window of B
  T* vs = bs + (kTM + W - 1) * kKCS;        // kTM x (W + 1) band tile
  const int WS = W + 1;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTM;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * kKC;
  const int tid = threadIdx.x;

  const int nrows = static_cast<int>(m - i0 < kTM ? m - i0 : kTM);
  const T* vtile = v + i0 * W;  // rows i0.. of v are contiguous
  for (int e = tid; e < kTM * W; e += kThreads) {
    const int r = e / W, j = e - r * W;
    vs[r * WS + j] = r < nrows ? vtile[e] : static_cast<T>(0);
  }
  const int64_t brow0 = start + i0 - padL;
  const int span = kTM + W - 1;
  for (int e = tid; e < span * kKC; e += kThreads) {
    const int t = e / kKC, c = e - t * kKC;
    const int64_t br = brow0 + t, bc = k0 + c;
    bs[t * kKCS + c] = (br >= 0 && br < n && bc < K) ? B[br * K + bc] : static_cast<T>(0);
  }
  __syncthreads();

  const int ty = tid / 16, tx = tid % 16;
  const int r0 = ty * 4;
  T acc[4][4];
  T win[4][4];  // win[a][q] = B window row r0 + a + j, column tx + 16q
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[a][q] = static_cast<T>(0);
      win[a][q] = a == 0 ? static_cast<T>(0) : bs[(r0 + a - 1) * kKCS + tx + 16 * q];
    }
  for (int j = 0; j < W; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      win[0][q] = win[1][q];
      win[1][q] = win[2][q];
      win[2][q] = win[3][q];
      win[3][q] = bs[(r0 + 3 + j) * kKCS + tx + 16 * q];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const T va = vs[(r0 + a) * WS + j];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][q] = mul_add(va, win[a][q], acc[a][q]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t i = i0 + r0 + a;
    if (i >= m) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t c = k0 + tx + 16 * q;
      if (c < K) C[i * K + c] = acc[a][q];
    }
  }
}

template <typename DT>
__global__ void __launch_bounds__(kThreads)
spmm_band_mxu_kernel(const DT* __restrict__ dt, const float* __restrict__ B, float* __restrict__ C,
                     int64_t m, int64_t n, int64_t K, int64_t start, int64_t padL) {
  __shared__ __align__(16) float ds[kCS][kMB];       // dt[k, c0 + cc, s]
  __shared__ __align__(16) float bsl[kCS][kKC + 4];  // B window rows c0 + cc
  const int64_t kb = blockIdx.x;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * kKC;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int s0 = ty * 8;
  const DT* dk = dt + kb * kWB * kMB;
  const int64_t brow0 = start + kb * kMB - padL;
  float acc[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[a][q] = 0.0f;

  for (int c0 = 0; c0 < kWB; c0 += kCS) {
    for (int e = tid; e < kCS * kMB; e += kThreads) {
      ds[e / kMB][e % kMB] = widen(dk[c0 * kMB + e]);
    }
    for (int e = tid; e < kCS * kKC; e += kThreads) {
      const int cc = e / kKC, c = e - cc * kKC;
      const int64_t br = brow0 + c0 + cc, bc = k0 + c;
      bsl[cc][c] = (br >= 0 && br < n && bc < K) ? round_b(B[br * K + bc], DT()) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int cc = 0; cc < kCS; ++cc) {
      float b[4], d[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = bsl[cc][tx + 16 * q];
#pragma unroll
      for (int a = 0; a < 8; ++a) d[a] = ds[cc][s0 + a];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(d[a], b[q], acc[a][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int64_t i = kb * kMB + s0 + a;
    if (i >= m) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t c = k0 + tx + 16 * q;
      if (c < K) C[i * K + c] = acc[a][q];
    }
  }
}

template <typename T>
int launch_band(const void* v, const void* B, void* C, int64_t m, int64_t n, int64_t K, int64_t W,
                int64_t start, int64_t padL, void* stream) {
  if (m <= 0 || K <= 0) return 0;
  const size_t smem = static_cast<size_t>((kTM + W - 1) * kKCS + kTM * (W + 1)) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(spmm_band_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((m + kTM - 1) / kTM),
                  static_cast<unsigned>((K + kKC - 1) / kKC));
  spmm_band_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), static_cast<const T*>(B), static_cast<T*>(C), m, n, K,
      static_cast<int>(W), start, padL);
  return static_cast<int>(cudaGetLastError());
}

template <typename DT>
int launch_mxu(const void* dt, const void* B, void* C, int64_t nblk, int64_t m, int64_t n,
               int64_t K, int64_t start, int64_t padL, void* stream) {
  if (m <= 0 || K <= 0 || nblk <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(nblk), static_cast<unsigned>((K + kKC - 1) / kKC));
  spmm_band_mxu_kernel<DT><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const DT*>(dt), static_cast<const float*>(B), static_cast<float*>(C), m, n, K,
      start, padL);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int spmm_band_f32(const void* v, const void* B, void* C, int64_t m, int64_t n, int64_t K,
                  int64_t W, int64_t start, int64_t padL, void* stream) {
  return launch_band<float>(v, B, C, m, n, K, W, start, padL, stream);
}

int spmm_band_f64(const void* v, const void* B, void* C, int64_t m, int64_t n, int64_t K,
                  int64_t W, int64_t start, int64_t padL, void* stream) {
  return launch_band<double>(v, B, C, m, n, K, W, start, padL, stream);
}

int spmm_band_mxu_f32(const void* dt, const void* B, void* C, int64_t nblk, int64_t m, int64_t n,
                      int64_t K, int64_t start, int64_t padL, void* stream) {
  return launch_mxu<float>(dt, B, C, nblk, m, n, K, start, padL, stream);
}

int spmm_band_mxu_bf16(const void* dt, const void* B, void* C, int64_t nblk, int64_t m,
                       int64_t n, int64_t K, int64_t start, int64_t padL, void* stream) {
  return launch_mxu<__nv_bfloat16>(dt, B, C, nblk, m, n, K, start, padL, stream);
}

}  // extern "C"
