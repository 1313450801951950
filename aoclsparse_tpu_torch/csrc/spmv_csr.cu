// CSR row-gather SpMV for NVIDIA Hopper (sm_90a), the mv kernel of the
// `segsum` execution form (mv KID 0):
//
//     y[i] = sum_{ptr[i] <= p < ptr[i + 1]} val[p] * x[ind[p]]     (0 <= i < m)
//
// over the planner's CSR (ExecForm.ptr, ind, val); every ind[p] lies in
// [0, n), as the planner's validated CSR holds it.
//
// It replaces no Pallas kernel. It is the hand kernel of the JAX package's
// XLA formulation
//   aoclsparse_tpu/kernels/xla/spmv.py:51  spmv_segsum  (mv KID 0)
// (gather, multiply, segment sum), which the port's planner sends general
// structure to on the card (planner/plan.py choose_mv_format): a scattered
// matrix's CSR moves far fewer bytes than the band of the `gen` composite
// or the routes of the `route` form.
//
// What bounds it: bytes. Each entry is read once, its index and its value
// (nnz * (4 + vsize) with int32 indices), the row pointers once
// ((m + 1) * 4), y written once (m * vsize), and x gathered, one read per
// entry whose line is not already in L2; at 2 flops an entry it is far
// below the card's flop:byte balance. A web graph's x (4 MB at a million
// rows in f32) fits the 50 MB L2, so the gathers mostly hit L2 and the
// stream of ind and val sets the time. Rows are short and uneven (a mean
// of 3 entries on the webbase stand-in, with hub rows of 4,700), so the
// design's aims are: no lane idle for long, and enough loads in flight.
//
// Design: two launches on one stream, which write disjoint rows.
// - spmv_csr_rows_kernel: a sub-warp of L lanes a row (L a power of two
//   from 2 to 32, chosen at plan time from the mean row length,
//   kernels/spmv_csr.py `sub_warp_width`). The lanes stride along the row
//   (lane l takes entries l, l + L, ...), read val, ind and x through the
//   read-only path (__ldg), and meet in a __shfl_down_sync butterfly inside
//   the sub-warp. A row longer than long_min = LONG_ROW_STEPS * L entries
//   is skipped here: on its sub-warp it would hold its warp for more than
//   LONG_ROW_STEPS strides while a row near the mean takes one.
// - spmv_csr_long_kernel: one CTA of kLongThreads threads a row of the
//   plan's long-row list (the rows past long_min, listed at plan time).
//   The threads stride the row four strides at a time (four independent
//   gathers in flight a thread), meet in warp shuffles, and thread 0 adds
//   the kLongThreads / 32 warp sums in warp order.
// The order of every sum is fixed by the structure (no atomics), so a run
// repeats bit for bit; it is not index_add_'s order, so a comparison with
// the plain version (kernels/plain_spmv.py spmv_segsum) takes the dtype's
// model tolerance. The sums are kept in the value type.
//
// Instances (plain C entry points, bound with ctypes), each for int32 or
// int64 row pointers and int32 or int64 column indices:
//   spmv_csr_f32, spmv_csr_f64, spmv_csr_c64 (float2), spmv_csr_c128 (double2)
// Each launches on the given stream, does not synchronise, allocates
// nothing, and returns the first cudaGetLastError() of its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;   // threads a block of the rows kernel
constexpr int kLongThreads = 256;  // threads a CTA of the long-row kernel
constexpr unsigned kFull = 0xffffffffu;

// value arithmetic: acc + a * b, a sum, and a shuffle down a sub-warp of
// width w (every lane of the warp takes part)
__device__ __forceinline__ float vzero(float) { return 0.0f; }
__device__ __forceinline__ double vzero(double) { return 0.0; }
__device__ __forceinline__ float2 vzero(float2) { return make_float2(0.0f, 0.0f); }
__device__ __forceinline__ double2 vzero(double2) { return make_double2(0.0, 0.0); }

__device__ __forceinline__ float vmad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double vmad(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float2 vmad(float2 a, float2 b, float2 c) {
  c.x = fmaf(a.x, b.x, c.x);
  c.x = fmaf(-a.y, b.y, c.x);
  c.y = fmaf(a.x, b.y, c.y);
  c.y = fmaf(a.y, b.x, c.y);
  return c;
}
__device__ __forceinline__ double2 vmad(double2 a, double2 b, double2 c) {
  c.x = fma(a.x, b.x, c.x);
  c.x = fma(-a.y, b.y, c.x);
  c.y = fma(a.x, b.y, c.y);
  c.y = fma(a.y, b.x, c.y);
  return c;
}

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ double vadd(double a, double b) { return a + b; }
__device__ __forceinline__ float2 vadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ double2 vadd(double2 a, double2 b) { return make_double2(a.x + b.x, a.y + b.y); }

__device__ __forceinline__ float vshfl(float v, int off, int w) { return __shfl_down_sync(kFull, v, off, w); }
__device__ __forceinline__ double vshfl(double v, int off, int w) { return __shfl_down_sync(kFull, v, off, w); }
__device__ __forceinline__ float2 vshfl(float2 v, int off, int w) {
  return make_float2(__shfl_down_sync(kFull, v.x, off, w), __shfl_down_sync(kFull, v.y, off, w));
}
__device__ __forceinline__ double2 vshfl(double2 v, int off, int w) {
  return make_double2(__shfl_down_sync(kFull, v.x, off, w), __shfl_down_sync(kFull, v.y, off, w));
}

// sub-warp rows: L lanes a row; rows past long_min are left to the
// long-row kernel
template <typename T, typename P, typename I, int L>
__global__ void __launch_bounds__(kRowThreads)
spmv_csr_rows_kernel(const P* __restrict__ ptr, const I* __restrict__ ind, const T* __restrict__ val,
                     const T* __restrict__ x, T* __restrict__ y, long long m, long long long_min) {
  const long long g = static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x;
  const long long row = g / L;
  const int lane = static_cast<int>(g & (L - 1));
  T acc = vzero(T());
  // the one value live across the loop besides its own: where the row's
  // sum goes (null past m, on a long row, or off lane 0), so the complex
  // instances with 64-bit pointers keep every value in registers
  T* out = nullptr;
  if (row < m) {
    const long long s = static_cast<long long>(__ldg(ptr + row));
    const long long e = static_cast<long long>(__ldg(ptr + row + 1));
    if (e - s <= long_min) {
      if (lane == 0) out = y + row;
      for (long long p = s + lane; p < e; p += L) {
        acc = vmad(__ldg(val + p), __ldg(x + __ldg(ind + p)), acc);
      }
    }
  }
  // every lane of the warp reaches the butterfly (the grid covers whole
  // warps; lanes past m or on a long row carry 0)
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) acc = vadd(acc, vshfl(acc, off, L));
  if (out != nullptr) *out = acc;
}

// one CTA a long row: four strides in flight a thread, then warp shuffles
// and the warp sums in warp order
template <typename T, typename P, typename I>
__global__ void __launch_bounds__(kLongThreads)
spmv_csr_long_kernel(const P* __restrict__ ptr, const I* __restrict__ ind, const T* __restrict__ val,
                     const T* __restrict__ x, T* __restrict__ y, const long long* __restrict__ rows) {
  __shared__ T part[kLongThreads / 32];
  const long long row = rows[blockIdx.x];
  const long long s = static_cast<long long>(__ldg(ptr + row));
  const long long e = static_cast<long long>(__ldg(ptr + row + 1));
  T a0 = vzero(T()), a1 = a0, a2 = a0, a3 = a0;
  long long p = s + threadIdx.x;
  for (; p + 3 * kLongThreads < e; p += 4 * kLongThreads) {
    const I c0 = __ldg(ind + p), c1 = __ldg(ind + p + kLongThreads);
    const I c2 = __ldg(ind + p + 2 * kLongThreads), c3 = __ldg(ind + p + 3 * kLongThreads);
    const T v0 = __ldg(val + p), v1 = __ldg(val + p + kLongThreads);
    const T v2 = __ldg(val + p + 2 * kLongThreads), v3 = __ldg(val + p + 3 * kLongThreads);
    a0 = vmad(v0, __ldg(x + c0), a0);
    a1 = vmad(v1, __ldg(x + c1), a1);
    a2 = vmad(v2, __ldg(x + c2), a2);
    a3 = vmad(v3, __ldg(x + c3), a3);
  }
  for (; p < e; p += kLongThreads) a0 = vmad(__ldg(val + p), __ldg(x + __ldg(ind + p)), a0);
  T acc = vadd(vadd(a0, a1), vadd(a2, a3));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc = vadd(acc, vshfl(acc, off, 32));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T sum = part[0];
#pragma unroll
    for (int w = 1; w < kLongThreads / 32; ++w) sum = vadd(sum, part[w]);
    y[row] = sum;
  }
}

template <typename T, typename P, typename I, int L>
cudaError_t launch_rows(const void* ptr, const void* ind, const void* val, const void* x, void* y, long long m,
                        long long long_min, cudaStream_t s) {
  const long long blocks = (m * L + kRowThreads - 1) / kRowThreads;
  spmv_csr_rows_kernel<T, P, I, L><<<static_cast<unsigned>(blocks), kRowThreads, 0, s>>>(
      static_cast<const P*>(ptr), static_cast<const I*>(ind), static_cast<const T*>(val),
      static_cast<const T*>(x), static_cast<T*>(y), m, long_min);
  return cudaGetLastError();
}

template <typename T, typename P, typename I>
int launch(const void* ptr, const void* ind, const void* val, const void* x, void* y, const void* long_rows,
           long long m, long long n_long, long long long_min, int lanes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m > 0) {
    cudaError_t err;
    switch (lanes) {
      case 2: err = launch_rows<T, P, I, 2>(ptr, ind, val, x, y, m, long_min, s); break;
      case 4: err = launch_rows<T, P, I, 4>(ptr, ind, val, x, y, m, long_min, s); break;
      case 8: err = launch_rows<T, P, I, 8>(ptr, ind, val, x, y, m, long_min, s); break;
      case 16: err = launch_rows<T, P, I, 16>(ptr, ind, val, x, y, m, long_min, s); break;
      case 32: err = launch_rows<T, P, I, 32>(ptr, ind, val, x, y, m, long_min, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_long > 0) {
    spmv_csr_long_kernel<T, P, I><<<static_cast<unsigned>(n_long), kLongThreads, 0, s>>>(
        static_cast<const P*>(ptr), static_cast<const I*>(ind), static_cast<const T*>(val),
        static_cast<const T*>(x), static_cast<T*>(y), static_cast<const long long*>(long_rows));
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaSuccess);
}

template <typename T>
int dispatch(const void* ptr, const void* ind, const void* val, const void* x, void* y, const void* long_rows,
             long long m, long long n_long, long long long_min, int lanes, int ptr64, int ind64, void* stream) {
  if (ptr64) {
    return ind64 ? launch<T, long long, long long>(ptr, ind, val, x, y, long_rows, m, n_long, long_min, lanes, stream)
                 : launch<T, long long, int>(ptr, ind, val, x, y, long_rows, m, n_long, long_min, lanes, stream);
  }
  return ind64 ? launch<T, int, long long>(ptr, ind, val, x, y, long_rows, m, n_long, long_min, lanes, stream)
               : launch<T, int, int>(ptr, ind, val, x, y, long_rows, m, n_long, long_min, lanes, stream);
}

}  // namespace

extern "C" {

// ptr (m + 1) and ind (nnz) int32 or int64 (ptr64, ind64), val (nnz) and
// x (n) of the instance's type, y (m) written; long_rows: the n_long rows
// (int64) past long_min, each given one CTA; lanes: the sub-warp width
// (2, 4, 8, 16 or 32)
int spmv_csr_f32(const void* ptr, const void* ind, const void* val, const void* x, void* y, const void* long_rows,
                 int64_t m, int64_t n_long, int64_t long_min, int lanes, int ptr64, int ind64, void* stream) {
  return dispatch<float>(ptr, ind, val, x, y, long_rows, m, n_long, long_min, lanes, ptr64, ind64, stream);
}

int spmv_csr_f64(const void* ptr, const void* ind, const void* val, const void* x, void* y, const void* long_rows,
                 int64_t m, int64_t n_long, int64_t long_min, int lanes, int ptr64, int ind64, void* stream) {
  return dispatch<double>(ptr, ind, val, x, y, long_rows, m, n_long, long_min, lanes, ptr64, ind64, stream);
}

int spmv_csr_c64(const void* ptr, const void* ind, const void* val, const void* x, void* y, const void* long_rows,
                 int64_t m, int64_t n_long, int64_t long_min, int lanes, int ptr64, int ind64, void* stream) {
  return dispatch<float2>(ptr, ind, val, x, y, long_rows, m, n_long, long_min, lanes, ptr64, ind64, stream);
}

int spmv_csr_c128(const void* ptr, const void* ind, const void* val, const void* x, void* y, const void* long_rows,
                  int64_t m, int64_t n_long, int64_t long_min, int lanes, int ptr64, int ind64, void* stream) {
  return dispatch<double2>(ptr, ind, val, x, y, long_rows, m, n_long, long_min, lanes, ptr64, ind64, stream);
}

}  // extern "C"
