// Level-scheduled sparse triangular solve for NVIDIA Hopper (sm_90a): sv
// KID 1, the solve of the planner's LevelForm (kernels/trsv_level.py), with
// K right-hand sides. For every row i of a lower-oriented triangle, in an
// order that respects its levels:
//
//   x[i] = (b[i] - sum_{j < i} L[i, j] * x[j]) * dinv[i]
//
// over a compact level-ordered CSR: position p = 0..m-1 walks the rows level
// by level; lrow[p] is the row, lptr[p]..lptr[p+1] its strict entries (lcol
// int32, lval), dinv[p] its inverted diagonal (1 for a unit triangle). Rows
// and columns are in the caller's index space (an upper source's reversal is
// folded into them), so B and X are the caller's row-major (m, K) arrays.
// Every strict entry is multiplied as stored, a zero included, so an Inf or
// NaN in solved x meets it as in the plain version (kernels/trsv_level.py
// level_step).
//
// Stands for the JAX package's XLA level loops (no Pallas kernel there):
//   aoclsparse_tpu/kernels/xla/trsv_level.py:138  _solve_levels_jit
//   aoclsparse_tpu/kernels/xla/trsv_level.py:157  _solve_runs_jit
//
// What bounds it: not bytes. The 104^3 stencil's ILU0 L factor (14.3M strict
// entries, 1.12M rows) moves about 0.13 GB, 0.04 ms at 3.35 TB/s, but its
// 722 levels are 722 dependent rounds: a row can start only when the rows it
// reads, written by other SMs, are visible to it. The floor is nlev times
// one dependency round trip (a store, its release, the reader's acquire and
// its load of x, all through L2): chip_smoke.py phase 6 measures it on a
// bidiagonal chain, one level a row. The blocked chain kernel
// (csrc/trsv_blocked.cu) walks the stencil's 17,576 blocks on one SM instead.
//
// Design, simple first (sync-free): one warp a row. A persistent grid,
// launched cooperatively so that every CTA is resident at once, deals the
// positions of the level order to its warps in turn (warp w takes w, w + W,
// w + 2W, ...). Lane l sums the row's entries l, l + 32, ... in order, each
// after it has seen ready[col] == epoch (ld.acquire.gpu) and then reading
// x[col] past the SM's L1 (ld.global.cg); the lanes meet in a fixed xor
// butterfly, so the same inputs give the same bits. Lane 0 writes the row's
// K values, then publishes them with st.release.gpu ready[row] = epoch.
// No deadlock: every warp is resident and walks its positions in order, and
// a row waits only on earlier positions, so the earliest unsolved row always
// has its inputs. The epoch is a per-form counter passed at launch, so the
// flags need no reset launch; the caller zeroes them when it wraps. A wait
// that outlasts kMaxPolls traps, so a malformed form fails the launch
// instead of hanging the card.
//
// Tried on the card and dropped, each slower on both the stencil's factor
// and the scatter triangle: rows claimed from a device-wide atomic ticket in
// place of the fixed deal (one atomic a row serialises in L2), a
// level-synchronous grid with a grid barrier a level, and 8 lanes a row in
// place of 32.
//
// Complex instances: the same kernel over float2 / double2 values (real,
// imaginary), each multiply-add a complex one (two FMAs a part), the lanes'
// butterfly and the row's (b - sum) * dinv in complex arithmetic; the
// release/acquire flags and the deal are the real instances'. The JAX
// package runs complex solves on the same XLA level loops, and no chain or
// window kernel has a complex instance, so on the card a complex triangle
// takes this kernel wherever its level count allows
// (planner/triangular.py pick_sv_engine).
//
// Instances (plain C entry points, bound with ctypes):
//   trsv_level_f32, trsv_level_f64, trsv_level_c64, trsv_level_c128
// Each launches one kernel on the given stream, does not synchronise,
// allocates nothing, adds 1 to *launches, and returns the first CUDA error of
// the occupancy query or the launch (0 on success; cudaErrorInvalidValue for
// arguments out of range).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// polls of one flag before the kernel traps (about 8 s at the 32 ns sleep):
// a malformed form (a column not before its row in the level order) fails
// the launch instead of hanging the card
constexpr long long kMaxPolls = 1ll << 28;

// the value arithmetic of the kernel, real and complex (float2 / double2:
// x the real part, y the imaginary part)
__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float2 mul_add(float2 a, float2 b, float2 c) {
  return make_float2(fmaf(a.x, b.x, fmaf(-a.y, b.y, c.x)), fmaf(a.x, b.y, fmaf(a.y, b.x, c.y)));
}
__device__ __forceinline__ double2 mul_add(double2 a, double2 b, double2 c) {
  return make_double2(fma(a.x, b.x, fma(-a.y, b.y, c.x)), fma(a.x, b.y, fma(a.y, b.x, c.y)));
}
template <typename T>
__device__ __forceinline__ T zero() { return T(0); }
template <>
__device__ __forceinline__ float2 zero<float2>() { return make_float2(0.f, 0.f); }
template <>
__device__ __forceinline__ double2 zero<double2>() { return make_double2(0.0, 0.0); }
// a + the value of lane (lane ^ s)
__device__ __forceinline__ float shfl_add(float a, int s) { return a + __shfl_xor_sync(0xffffffffu, a, s); }
__device__ __forceinline__ double shfl_add(double a, int s) { return a + __shfl_xor_sync(0xffffffffu, a, s); }
__device__ __forceinline__ float2 shfl_add(float2 a, int s) {
  return make_float2(shfl_add(a.x, s), shfl_add(a.y, s));
}
__device__ __forceinline__ double2 shfl_add(double2 a, int s) {
  return make_double2(shfl_add(a.x, s), shfl_add(a.y, s));
}
// a row's value: (b - sum) * dinv
__device__ __forceinline__ float finish(float b, float acc, float d) { return (b - acc) * d; }
__device__ __forceinline__ double finish(double b, double acc, double d) { return (b - acc) * d; }
__device__ __forceinline__ float2 finish(float2 b, float2 acc, float2 d) {
  const float r = b.x - acc.x, i = b.y - acc.y;
  return make_float2(r * d.x - i * d.y, r * d.y + i * d.x);
}
__device__ __forceinline__ double2 finish(double2 b, double2 acc, double2 d) {
  const double r = b.x - acc.x, i = b.y - acc.y;
  return make_double2(r * d.x - i * d.y, r * d.y + i * d.x);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// KC: columns a pass over a row's entries takes (1, 4 or 16; K > 16 in
// chunks of 16)
template <typename T, int KC>
__global__ void __launch_bounds__(kThreads)
    trsv_level_kernel(const int32_t* __restrict__ lrow, const int32_t* __restrict__ lptr,
                      const int32_t* __restrict__ lcol, const T* __restrict__ lval, const T* __restrict__ dinv,
                      const T* __restrict__ B, T* X, int* ready, int m, int K, int epoch) {
  const int lane = threadIdx.x & 31;
  const int warps = static_cast<int>(gridDim.x) * kWarps;
  for (int p = static_cast<int>(blockIdx.x) * kWarps + static_cast<int>(threadIdx.x) / 32; p < m; p += warps) {
    const int row = __ldg(lrow + p);
    const int beg = __ldg(lptr + p);
    const int end = __ldg(lptr + p + 1);
    const T d = __ldg(dinv + p);
    for (int c0 = 0; c0 < K; c0 += KC) {
      T acc[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) acc[c] = zero<T>();
      for (int j = beg + lane; j < end; j += 32) {
        const int col = __ldg(lcol + j);
        const T v = __ldg(lval + j);
        if (c0 == 0) {
          for (long long n = 0; ld_acquire(ready + col) != epoch; ++n) {
            if (n > kMaxPolls) __trap();
            __nanosleep(32);
          }
        }
        const T* xc = X + static_cast<int64_t>(col) * K + c0;
#pragma unroll
        for (int c = 0; c < KC; ++c)
          if (KC == 1 || c0 + c < K) acc[c] = mul_add(v, __ldcg(xc + c), acc[c]);
      }
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[c] = shfl_add(acc[c], s);
      }
      if (lane == 0) {
        const int64_t o = static_cast<int64_t>(row) * K + c0;
#pragma unroll
        for (int c = 0; c < KC; ++c)
          if (KC == 1 || c0 + c < K) X[o + c] = finish(__ldg(B + o + c), acc[c], d);
      }
    }
    if (lane == 0) st_release(ready + row, epoch);
  }
}

template <typename T, int KC>
int launch_kc(const int32_t* lrow, const int32_t* lptr, const int32_t* lcol, const T* lval, const T* dinv, const T* B,
              T* X, int* ready, int m, int K, int epoch, cudaStream_t stream) {
  auto kern = trsv_level_kernel<T, KC>;
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t want = (static_cast<int64_t>(m) + kWarps - 1) / kWarps;
  const int64_t cap = static_cast<int64_t>(nsm) * per_sm;
  const dim3 grid(static_cast<unsigned>(want < cap ? want : cap)), block(kThreads);
  void* args[] = {&lrow, &lptr, &lcol, &lval, &dinv, &B, &X, &ready, &m, &K, &epoch};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), grid, block, args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* lrow, const void* lptr, const void* lcol, const void* lval, const void* dinv, const void* B,
           void* X, void* ready, int64_t m, int64_t K, int64_t epoch, void* stream, int64_t* launches) {
  if (m < 1 || m > INT32_MAX || K < 1 || K > INT32_MAX || epoch < 1 || epoch > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* r = static_cast<const int32_t*>(lrow);
  const auto* pt = static_cast<const int32_t*>(lptr);
  const auto* c = static_cast<const int32_t*>(lcol);
  const auto* v = static_cast<const T*>(lval);
  const auto* d = static_cast<const T*>(dinv);
  const auto* b = static_cast<const T*>(B);
  auto* x = static_cast<T*>(X);
  auto* f = static_cast<int*>(ready);
  const int mi = static_cast<int>(m), Ki = static_cast<int>(K), e = static_cast<int>(epoch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (K == 1)
    rc = launch_kc<T, 1>(r, pt, c, v, d, b, x, f, mi, Ki, e, st);
  else if (K <= 4)
    rc = launch_kc<T, 4>(r, pt, c, v, d, b, x, f, mi, Ki, e, st);
  else
    rc = launch_kc<T, 16>(r, pt, c, v, d, b, x, f, mi, Ki, e, st);
  if (rc == 0) *launches += 1;
  return rc;
}

}  // namespace

extern "C" {

int trsv_level_f32(const void* lrow, const void* lptr, const void* lcol, const void* lval, const void* dinv,
                   const void* B, void* X, void* ready, int64_t m, int64_t K, int64_t epoch, void* stream,
                   int64_t* launches) {
  return launch<float>(lrow, lptr, lcol, lval, dinv, B, X, ready, m, K, epoch, stream, launches);
}

int trsv_level_f64(const void* lrow, const void* lptr, const void* lcol, const void* lval, const void* dinv,
                   const void* B, void* X, void* ready, int64_t m, int64_t K, int64_t epoch, void* stream,
                   int64_t* launches) {
  return launch<double>(lrow, lptr, lcol, lval, dinv, B, X, ready, m, K, epoch, stream, launches);
}

int trsv_level_c64(const void* lrow, const void* lptr, const void* lcol, const void* lval, const void* dinv,
                   const void* B, void* X, void* ready, int64_t m, int64_t K, int64_t epoch, void* stream,
                   int64_t* launches) {
  return launch<float2>(lrow, lptr, lcol, lval, dinv, B, X, ready, m, K, epoch, stream, launches);
}

int trsv_level_c128(const void* lrow, const void* lptr, const void* lcol, const void* lval, const void* dinv,
                    const void* B, void* X, void* ready, int64_t m, int64_t K, int64_t epoch, void* stream,
                    int64_t* launches) {
  return launch<double2>(lrow, lptr, lcol, lval, dinv, B, X, ready, m, K, epoch, stream, launches);
}

}  // extern "C"
