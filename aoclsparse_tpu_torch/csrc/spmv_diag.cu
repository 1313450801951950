// Diagonal-form SpMV for NVIDIA Hopper (sm_90a), the mv kernel of the
// planner's `diag` execution form (mv KID 6):
//
//     y[i] = sum_{d < ndiag, 0 <= i + offs[d] < n} dvals[d, i] * x[i + offs[d]]     (0 <= i < m)
//
// over the (ndiag, m) row-aligned diagonal values (ExecForm.dia_val,
// dvals[d, i] = A[i, i + offs[d]]) and the sorted int64 offsets
// (ExecForm.dia_offs); x has n entries. A slot whose column lies outside
// [0, n) is neither read nor multiplied, so no zero-padded copy of x
// exists; every slot whose column lies inside is multiplied, stored zeros
// included, so a stored zero meeting an Inf of x gives NaN where the JAX
// package's padded slice of x gives it.
//
// It replaces no Pallas kernel. It is the hand kernel of the JAX package's
// XLA formulation
//   aoclsparse_tpu/kernels/xla/spmv.py:606  spmv_diag  (mv KID 6)
// (its unrolled static slices, :615, and its scan over the diagonals,
// :624), one fused XLA kernel on a TPU that reads each diagonal once. The
// port ran it as plain torch (kernels/plain_spmv.py spmv_diag: a (chunk, m)
// gather of x and a sum, about nine launches a call). HPCG's 27-point
// stencil and its strict triangles take the `diag` form (planner/plan.py
// structure_mv_format), so it is the matvec of every CG and ILU0-PCG
// iteration there and two of every SGS-PCG iteration.
//
// What bounds it: bytes. The values of the slots whose column lies in
// range are read once (at most ndiag * m), x once and y written once: on
// the 104^3 stencil in f32 129.7 MB, 0.0387 ms at 3,350 GB/s; at one FMA a
// value it is two orders of magnitude below the card's flop:byte balance.
// The values are 93 % of the bytes, so the design streams them once,
// coalesced, and keeps x (4.5 MB at that size) in L2.
//
// Design. One launch; a CTA of kThreads threads owns R * kThreads
// consecutive rows (R = kRows = 4), and
// thread t the rows r0 + t + k * kThreads, k < R, so every load of a warp
// is 32 neighbouring elements: coalesced whatever m is, with no aligned
// and scalar variants. The CTA stages its offsets through shared memory,
// kThreads at a time. For each diagonal, the CTA skips it whole where its
// columns miss [0, n) for all the CTA's rows; runs R unguarded loads of
// the values and R of x where they all fall inside; and guards each row
// otherwise (the first and last tiles of a band, the grid's last tile). A
// thread issues its R value loads and R x loads before its R FMAs: the
// values with the evict-first hint (__ldcs), so the stream of diagonals
// does not push x out of L2, and x through the read-only path (__ldg),
// where the neighbouring offsets of a stencil (-1, 0, +1) share L1 lines.
// The sums stay in registers, one per row, and y is written once; there is
// no reset pass and no atomic, and every sum takes the diagonals in offset
// order, so a run repeats bit for bit. The value index d * m + i is 64-bit
// (d * m passes 2^31 past m = 11.2 M at 192 diagonals).
//
// R is a compile-time constant, SPMV_DIAG_R, 4 unless given as a -D
// define (scripts/diag_bench.py --rows builds this file alone at R = 1, 2
// and 8 to sweep it on the card; the package is built at 4).
//
// Instances (plain C entry points, bound with ctypes):
//   spmv_diag_f32  : dvals f32,  x f32,  y f32, f32 sums
//   spmv_diag_bf16 : dvals bf16, x bf16, y bf16, f32 sums rounded once
//   spmv_diag_f64  : dvals f64,  x f64,  y f64, f64 sums
// Each launches once on the given stream (nothing where m = 0), does not
// synchronise, allocates nothing, and returns cudaGetLastError() of its
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SPMV_DIAG_R
#define SPMV_DIAG_R 4
#endif

namespace {

constexpr int kThreads = 256;  // threads a CTA; also the offsets staged at a time
constexpr int kRows = SPMV_DIAG_R;  // R, the rows a thread
static_assert(kRows >= 1 && kRows <= 8, "SPMV_DIAG_R: 1 to 8 rows a thread");

// loads: the values streamed (evict first), x through the read-only path
__device__ __forceinline__ float load_cs(const float* p) { return __ldcs(p); }
__device__ __forceinline__ double load_cs(const double* p) { return __ldcs(p); }
__device__ __forceinline__ float load_cs(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float load_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ double load_ro(const double* p) { return __ldg(p); }
__device__ __forceinline__ float load_ro(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ float fma_acc(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return fma(a, b, c); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// T: the values', x's and y's type; A: the sums' type
template <typename T, typename A>
__global__ void __launch_bounds__(kThreads)
spmv_diag_kernel(const T* __restrict__ dvals, const long long* __restrict__ offs, long long ndiag,
                 const T* __restrict__ x, T* __restrict__ y, long long m, long long n) {
  constexpr int R = kRows;
  __shared__ long long s_off[kThreads];
  const int tid = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * (R * kThreads);
  const long long r1 = min(r0 + R * kThreads, m);  // the tile's rows [r0, r1)
  const bool whole = r1 - r0 == R * kThreads;
  A acc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = A(0);
  for (long long c0 = 0; c0 < ndiag; c0 += kThreads) {
    const int nc = static_cast<int>(min(static_cast<long long>(kThreads), ndiag - c0));
    __syncthreads();  // the last chunk's offsets are read
    if (tid < nc) s_off[tid] = __ldg(offs + c0 + tid);
    __syncthreads();
    for (int j = 0; j < nc; ++j) {
      const long long o = s_off[j];
      // the tile's columns are [r0 + o, r1 - 1 + o]: the same test in every
      // thread, so the branches below never split a warp
      if (r1 - 1 + o < 0 || r0 + o >= n) continue;
      const T* __restrict__ dv = dvals + (c0 + j) * m;
      if (whole && r0 + o >= 0 && r1 - 1 + o < n) {
        A v[R], xv[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const long long i = r0 + tid + k * kThreads;
          v[k] = load_cs(dv + i);
          xv[k] = load_ro(x + i + o);
        }
#pragma unroll
        for (int k = 0; k < R; ++k) acc[k] = fma_acc(v[k], xv[k], acc[k]);
      } else {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const long long i = r0 + tid + k * kThreads, c = i + o;
          if (i < r1 && c >= 0 && c < n) acc[k] = fma_acc(load_cs(dv + i), load_ro(x + c), acc[k]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const long long i = r0 + tid + k * kThreads;
    if (i < r1) store(y + i, acc[k]);
  }
}

template <typename T, typename A>
int launch(const void* dvals, const void* offs, long long ndiag, const void* x, void* y, long long m, long long n,
           void* stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  const long long grid = (m + kRows * kThreads - 1) / (kRows * kThreads);
  spmv_diag_kernel<T, A><<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dvals), static_cast<const long long*>(offs), ndiag, static_cast<const T*>(x),
      static_cast<T*>(y), m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dvals (ndiag, m) row-major, offs (ndiag) int64 sorted, x (n), y (m)
// written
int spmv_diag_f32(const void* dvals, const void* offs, int64_t ndiag, const void* x, void* y, int64_t m, int64_t n,
                  void* stream) {
  return launch<float, float>(dvals, offs, ndiag, x, y, m, n, stream);
}

int spmv_diag_bf16(const void* dvals, const void* offs, int64_t ndiag, const void* x, void* y, int64_t m, int64_t n,
                   void* stream) {
  return launch<__nv_bfloat16, float>(dvals, offs, ndiag, x, y, m, n, stream);
}

int spmv_diag_f64(const void* dvals, const void* offs, int64_t ndiag, const void* x, void* y, int64_t m, int64_t n,
                  void* stream) {
  return launch<double, double>(dvals, offs, ndiag, x, y, m, n, stream);
}

}  // extern "C"
