// Diagonal-form SpMM for NVIDIA Hopper (sm_90a), the mm kernel of the
// planner's `diag` execution form (mm KID 7):
//
//     C[i, :] = sum_{d < ndiag} dvals[d, i] * B[i + offs[d], :]     (0 <= i < m)
//
// over the (ndiag, m) diagonal values (ExecForm.dia_val, dvals[d, i] =
// A[i, i + offs[d]]) and a dense row-major (n, K) B. B rows outside [0, n)
// contribute 0, so no padded copy of B exists; the offsets arrive as a
// small device array, so one kernel serves every offset set.
//
// Replaces aoclsparse_tpu/kernels/pallas/spmv.py:446 pallas_spmm_diag and
// its dispatcher spmm_diag (aoclsparse_tpu/kernels/xla/spmm.py:263). Their
// TPU machinery has no counterpart: the C^T lane-shift formulation, the
// one-hot sublane extraction of a diagonal's values, the VMEM tile picker
// diagmm_tiles, the cluster split _cluster_offsets and the unroll cap.
//
// What bounds it, at the 27-point stencil of a 104^3 grid (m = n =
// 1,124,864, 27 diagonals, K = 64, f32): 121.5 MB of dvals + 288 MB of B +
// 288 MB of C = 697 MB at 3350 GB/s = 0.21 ms; 1.94 G FMA at 33.5 T FMA/s
// = 0.058 ms, so bytes bound it. Each B row is wanted by 27 rows of C; the
// design reads it from device memory about once by keeping the reuse in
// the caches: a CTA's rows i0..i0+63 read, per diagonal, the 64 B rows
// starting at i0 + offs[d]; neighbouring diagonals (a stencil's +-1 in x)
// hit the same lines in L1, and the distant ones (+-104, +-104^2 rows) are
// read again by CTAs that run at about the same time, from the 50 MB L2
// (the stencil's full span of 2 * 10921 rows is 5.6 MB of B at K = 64).
//
// Design: a CTA of 256 threads (8 warps) owns 64 rows and 64 columns. Warp
// g owns rows g*8 .. g*8+7; lane l owns columns l and l + 32, so each B
// row load of a warp is 128 contiguous bytes in f32. A thread keeps its 16
// sums in registers and walks the diagonals in increasing offset order,
// the order the plain version sums in. dvals[d, i] is one value per row,
// read by all lanes of the warp at once (one broadcast transaction).
//
// Instances (plain C entry points, bound with ctypes):
//   spmm_diag_f32  : dvals f32,  B f32, C f32
//   spmm_diag_bf16 : dvals bf16, B f32, C f32 (f32 accumulation: the mixed mode)
//   spmm_diag_f64  : dvals f64,  B f64, C f64
// Each launches on the given stream, does not synchronise, allocates
// nothing, and returns the CUDA error of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // rows per CTA: 8 warps x 8 rows
constexpr int kCols = 64;  // columns per CTA: 32 lanes x 2

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }

template <typename DV, typename T>
__global__ void __launch_bounds__(kThreads)
spmm_diag_kernel(const DV* __restrict__ dvals, const int64_t* __restrict__ offs, int64_t ndiag,
                 const T* __restrict__ B, T* __restrict__ C, int64_t m, int64_t n, int64_t K) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows + warp * 8;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kCols + lane;
  const bool col0 = c0 < K, col1 = c0 + 32 < K;
  T acc[8][2];
#pragma unroll
  for (int a = 0; a < 8; ++a) acc[a][0] = acc[a][1] = static_cast<T>(0);

  for (int64_t d = 0; d < ndiag; ++d) {
    const int64_t off = offs[d];
    const DV* dv = dvals + d * m;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int64_t i = r0 + a;
      const int64_t j = i + off;
      if (i < m && j >= 0 && j < n) {
        const T w = widen(dv[i]);
        const T* bj = B + j * K + c0;
        if (col0) acc[a][0] = mul_add(w, bj[0], acc[a][0]);
        if (col1) acc[a][1] = mul_add(w, bj[32], acc[a][1]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int64_t i = r0 + a;
    if (i < m) {
      if (col0) C[i * K + c0] = acc[a][0];
      if (col1) C[i * K + c0 + 32] = acc[a][1];
    }
  }
}

template <typename DV, typename T>
int launch(const void* dvals, const void* offs, int64_t ndiag, const void* B, void* C, int64_t m,
           int64_t n, int64_t K, void* stream) {
  if (m <= 0 || K <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((m + kRows - 1) / kRows),
                  static_cast<unsigned>((K + kCols - 1) / kCols));
  spmm_diag_kernel<DV, T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const DV*>(dvals), static_cast<const int64_t*>(offs), ndiag,
      static_cast<const T*>(B), static_cast<T*>(C), m, n, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int spmm_diag_f32(const void* dvals, const void* offs, int64_t ndiag, const void* B, void* C,
                  int64_t m, int64_t n, int64_t K, void* stream) {
  return launch<float, float>(dvals, offs, ndiag, B, C, m, n, K, stream);
}

int spmm_diag_bf16(const void* dvals, const void* offs, int64_t ndiag, const void* B, void* C,
                   int64_t m, int64_t n, int64_t K, void* stream) {
  return launch<__nv_bfloat16, float>(dvals, offs, ndiag, B, C, m, n, K, stream);
}

int spmm_diag_f64(const void* dvals, const void* offs, int64_t ndiag, const void* B, void* C,
                  int64_t m, int64_t n, int64_t K, void* stream) {
  return launch<double, double>(dvals, offs, ndiag, B, C, m, n, K, stream);
}

}  // extern "C"
