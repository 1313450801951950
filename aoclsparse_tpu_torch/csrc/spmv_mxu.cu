// Block-window band SpMV for NVIDIA Hopper (sm_90a), over the
// (nblk, 256, 128) block windows of a band (ExecForm.band_mxu_dt,
// kernels/spmm_band.py `band_mxu_blocks`: dt[k, c, s] = A-band entry c - s
// of row 128k + s for 0 <= c - s < W, W <= 129, else 0):
//
//     y[128k + s] = sum_{c < 256} dt[k, c, s] * x[start + 128k + c - padL]   (128k + s < m)
//
// x indices outside [0, n) contribute 0, so no padded copy of x is made.
// The planner's peel spill is added by the wrapper after the launch.
//
// Replaces aoclsparse_tpu/kernels/pallas/spmv.py:1019 pallas_spmv_band_mxu,
// which runs each 128-row block as a (1, 256) x (256, 128) product on the
// TPU's matrix unit. A matrix-vector product has one column: Hopper's
// tensor cores would idle on it, so this is a CUDA-core kernel, and it is
// its own kernel, not the K = 1 case of the block-window SpMM
// (csrc/spmm_band.cu spmm_band_mxu, whose tile is laid out for 64 columns).
//
// What bounds it: the windows hold 256 x 128 values a block, twice the
// band's W x 128 at W = 128, because their zero triangles are stored; the
// kernel reads them all, as the TPU kernel does. At the bench operand
// (m = 262144) that is 268 MB of f32 windows (134 MB as bf16) against 2 MB
// of x and y, at 2 flops a value: device-memory bandwidth bounds it.
//
// Design: a CTA of 256 threads owns kBlk = 2 consecutive 128-row blocks.
// It stages their x window, 128 (kBlk + 1) values zero outside [0, n), in
// shared memory (the bf16 instance rounds it to bf16 there, as the JAX
// kernel's xq.astype(dt.dtype) does, spmv.py:1009). Thread s of block q
// walks c = 0..255 reading dt[k, c, s]: a warp reads 32 consecutive values
// of one window row, and all its lanes read the same x value (a broadcast).
// The c loop is unrolled so each thread keeps eight loads in flight. The
// sum is float32, over c in increasing order.
//
// Instances (plain C entry points, bound with ctypes):
//   spmv_band_mxu_f32  : dt f32,  x f32, y f32
//   spmv_band_mxu_bf16 : dt bf16, x f32 rounded to bf16, y f32 (f32 sums)
// Each launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMB = 128;  // rows a block
constexpr int kWB = 256;  // window rows a block
constexpr int kBlk = 2;   // blocks a CTA
constexpr int kThreads = kMB * kBlk;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// x in the dt dtype: f32 stays, bf16 rounds to nearest even
__device__ __forceinline__ float round_x(float v, float) { return v; }
__device__ __forceinline__ float round_x(float v, __nv_bfloat16) { return __bfloat162float(__float2bfloat16(v)); }

template <typename DT>
__global__ void __launch_bounds__(kThreads)
spmv_mxu_kernel(const DT* __restrict__ dt, const float* __restrict__ x, float* __restrict__ y, int64_t nblk,
                int64_t m, int64_t n, int64_t start, int64_t padL) {
  __shared__ float xs[kMB * (kBlk + 1)];
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kBlk;
  const int64_t xbase = start + k0 * kMB - padL;  // x index held by xs[0]
  for (int e = threadIdx.x; e < kMB * (kBlk + 1); e += kThreads) {
    const int64_t k = xbase + e;
    xs[e] = (k >= 0 && k < n) ? round_x(x[k], DT()) : 0.0f;
  }
  __syncthreads();
  const int q = threadIdx.x / kMB, s = threadIdx.x % kMB;
  const int64_t kb = k0 + q;
  const int64_t i = kb * kMB + s;
  if (kb >= nblk || i >= m) return;
  const DT* p = dt + kb * kWB * kMB + s;
  const float* xw = xs + q * kMB;
  float acc = 0.0f;
#pragma unroll 8
  for (int c = 0; c < kWB; ++c) acc = fmaf(widen(p[c * kMB]), xw[c], acc);
  y[i] = acc;
}

template <typename DT>
int launch(const void* dt, const void* x, void* y, int64_t nblk, int64_t m, int64_t n, int64_t start,
           int64_t padL, void* stream) {
  if (m <= 0 || nblk <= 0) return 0;
  const int64_t grid = (nblk + kBlk - 1) / kBlk;
  spmv_mxu_kernel<DT><<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const DT*>(dt), static_cast<const float*>(x), static_cast<float*>(y), nblk, m, n, start, padL);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int spmv_band_mxu_f32(const void* dt, const void* x, void* y, int64_t nblk, int64_t m, int64_t n, int64_t start,
                      int64_t padL, void* stream) {
  return launch<float>(dt, x, y, nblk, m, n, start, padL, stream);
}

int spmv_band_mxu_bf16(const void* dt, const void* x, void* y, int64_t nblk, int64_t m, int64_t n,
                       int64_t start, int64_t padL, void* stream) {
  return launch<__nv_bfloat16>(dt, x, y, nblk, m, n, start, padL, stream);
}

}  // extern "C"
