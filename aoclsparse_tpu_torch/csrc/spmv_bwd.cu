// Group-window SpMV for NVIDIA Hopper (sm_90a), the mv kernel of the `bwd`
// execution form (mv KID 5):
//
//     y[8b + r] = sum_{t < W} win[b, r, t] * x[8 (b + base8) + t - padL]
//                 + sum of the peel spill entries of row 8b + r
//
// over the (nblk, 8, W) row-major group windows `win` (ExecForm.bwd_val of
// kind "bwd"; win[b, r, t] = A[8b + r, 8 (b + base8) - padL + t]); terms
// whose x index falls outside [0, n) contribute 0, so a window that starts
// left of column 0 (padL > 0) needs no padded copy of x. Rows at or past m
// are not written. The spill is the planner's peel: COO triplets (sp_val,
// sp_ind, sp_rows) sorted by row, with sp_gptr[b] the first entry of group b.
//
// Replaces the JAX package's TPU kernel
//   aoclsparse_tpu/kernels/pallas/spmv.py:1093  pallas_spmv_bwd
// and the XLA row it stands beside (aoclsparse_tpu/kernels/xla/spmv.py:129
// spmv_bwd, mv KID 5). The TPU kernel rolls x so that two TM-chunks cover a
// tile's windows and adds the spill outside; here each warp reads its own
// window straight from x, and the spill is added inside the same launch.
//
// What bounds it: the windows are 8 W values a group streamed once, against
// n values of x and m of y. At W = 136 and m = 262144 that is 143 MB of f32
// band (71 MB as bf16) against 2 MB of x and y, at 2 flops per band value,
// far below the card's flop:byte balance. So device-memory bandwidth bounds
// the kernel, and the design has one aim: read every band value once, in
// full 128-byte transactions, with several loads in flight.
//
// Design: one warp per 8-row group, kWarps groups per block. The group's
// 8 W values are contiguous; lane l walks t = l, l + 32, ... < W, loads the
// x value of its t once (read-only path; neighbouring groups share most of
// the window, so x comes from L1/L2) and reads win[b, r, t] for r = 0..7:
// for each r the warp reads 32 consecutive band values (128 bytes in f32),
// and the 8 loads of one step are independent. Each lane keeps 8 partial
// sums. The group's spill entries are split over the 32 lanes too, each
// adding its products into the partial sum of its row: the peel spills the
// clipped windows at the matrix's edges, so a few groups hold ~100 entries
// each; walked serially by one lane a row they made a tail of dependent
// loads that cost the bench form (W = 136, m = 262144) 0.037 ms of 0.106 on
// an H100. A
// butterfly of shuffles then gives every lane all 8 row sums, and lanes 0-7
// write y[8b + lane] (one 32-byte store). Sums are kept in float32 (float64
// for the f64 instance).
//
// Instances (plain C entry points, bound with ctypes):
//   spmv_bwd_f32  : band f32,  x f32, accumulate f32
//   spmv_bwd_bf16 : band bf16, x f32, accumulate f32 (__bfloat162float only)
//   spmv_bwd_f64  : band f64,  x f64, accumulate f64
// Each launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // groups (warps) per block
constexpr int kG = 8;      // rows per group

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }

template <typename VT, typename T>
__global__ void __launch_bounds__(kWarps * 32)
spmv_bwd_kernel(const VT* __restrict__ win, const T* __restrict__ x, T* __restrict__ y,
                const T* __restrict__ sp_val, const int64_t* __restrict__ sp_ind,
                const int64_t* __restrict__ sp_rows, const int64_t* __restrict__ sp_gptr,
                int64_t nblk, int64_t m, int64_t n, int W, int64_t base8, int64_t padL) {
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= nblk) return;  // uniform across the warp
  const VT* g = win + b * kG * static_cast<int64_t>(W);
  const int64_t x0 = kG * (b + base8) - padL;  // x index of window position 0

  T acc[kG];
#pragma unroll
  for (int r = 0; r < kG; ++r) acc[r] = static_cast<T>(0);
#pragma unroll 2
  for (int t = lane; t < W; t += 32) {
    const int64_t k = x0 + t;
    const T xv = (k >= 0 && k < n) ? __ldg(x + k) : static_cast<T>(0);
#pragma unroll
    for (int r = 0; r < kG; ++r) acc[r] = mul_add(widen(g[r * W + t]), xv, acc[r]);
  }
  if (sp_gptr != nullptr) {
    const int64_t e1 = sp_gptr[b + 1];
    for (int64_t e = sp_gptr[b] + lane; e < e1; e += 32) {
      const T c = sp_val[e] * __ldg(x + sp_ind[e]);
      const int64_t r = sp_rows[e] - kG * b;
#pragma unroll
      for (int rr = 0; rr < kG; ++rr) acc[rr] += (r == rr) ? c : static_cast<T>(0);
    }
  }
#pragma unroll
  for (int r = 0; r < kG; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  }
  if (lane >= kG) return;
  T out = acc[0];
#pragma unroll
  for (int r = 1; r < kG; ++r) out = (lane == r) ? acc[r] : out;
  const int64_t i = kG * b + lane;
  if (i < m) y[i] = out;
}

template <typename VT, typename T>
int launch(const void* win, const void* x, void* y, const void* sp_val, const void* sp_ind,
           const void* sp_rows, const void* sp_gptr, int64_t nblk, int64_t m, int64_t n,
           int64_t W, int64_t base8, int64_t padL, void* stream) {
  if (nblk <= 0 || m <= 0) return 0;
  const int64_t blocks = (nblk + kWarps - 1) / kWarps;
  spmv_bwd_kernel<VT, T><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const VT*>(win), static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const T*>(sp_val), static_cast<const int64_t*>(sp_ind),
      static_cast<const int64_t*>(sp_rows), static_cast<const int64_t*>(sp_gptr), nblk, m, n,
      static_cast<int>(W), base8, padL);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int spmv_bwd_f32(const void* win, const void* x, void* y, const void* sp_val, const void* sp_ind,
                 const void* sp_rows, const void* sp_gptr, int64_t nblk, int64_t m, int64_t n,
                 int64_t W, int64_t base8, int64_t padL, void* stream) {
  return launch<float, float>(win, x, y, sp_val, sp_ind, sp_rows, sp_gptr, nblk, m, n, W, base8,
                              padL, stream);
}

int spmv_bwd_bf16(const void* win, const void* x, void* y, const void* sp_val, const void* sp_ind,
                  const void* sp_rows, const void* sp_gptr, int64_t nblk, int64_t m, int64_t n,
                  int64_t W, int64_t base8, int64_t padL, void* stream) {
  return launch<__nv_bfloat16, float>(win, x, y, sp_val, sp_ind, sp_rows, sp_gptr, nblk, m, n, W,
                                      base8, padL, stream);
}

int spmv_bwd_f64(const void* win, const void* x, void* y, const void* sp_val, const void* sp_ind,
                 const void* sp_rows, const void* sp_gptr, int64_t nblk, int64_t m, int64_t n,
                 int64_t W, int64_t base8, int64_t padL, void* stream) {
  return launch<double, double>(win, x, y, sp_val, sp_ind, sp_rows, sp_gptr, nblk, m, n, W, base8,
                                padL, stream);
}

}  // extern "C"
