// Diagonal-form SpMM for NVIDIA Hopper (sm_90a), the mm kernel of the
// planner's `diag` execution form (mm KID 7):
//
//     C[i, :] = sum_{d < ndiag} dvals[d, i] * B[i + offs[d], :]     (0 <= i < m)
//
// over the (ndiag, m) diagonal values (ExecForm.dia_val, dvals[d, i] =
// A[i, i + offs[d]]) and a dense row-major (n, K) B. B rows outside [0, n)
// contribute 0, so no padded copy of B exists.
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
// = 0.058 ms, so bytes bound it. Each B row is wanted by 27 rows of C.
// Reading a diagonal's B rows straight from global memory, as a first
// design did, asks L2 for every one of them again (7.8 GB of requests,
// about 2.7 GB of L2 traffic after L1) with one L2 round trip a diagonal.
//
// Design. The host groups the sorted offsets into windows of consecutive
// offsets whose B rows fit one shared-memory stage (kernels/spmm_diag.py
// `diag_windows`: the stencil's 27 offsets make 3 windows of 9, each
// spanning 210 + R rows) and splits each window into runs of at most
// kRunMax consecutive offsets; the table of windows and runs is built once
// per offset set and passed as a small device array. A CTA tile owns R
// rows and one 128-byte column chunk (32 f32 / 16 f64 columns); for each
// window it stages, with 16-byte cp.async copies, the window's diagonal
// values (nd x R) and its R + span B rows of the chunk (zero outside
// [0, n) and past K). So a B row leaves L2 about (R + span) / R times per
// window and column chunk: 3 x 722 / 512 x 288 MB = 1.22 GB on the stencil
// in f32, against 2.7 GB. The grid is persistent: CTA b takes tiles b,
// b + grid, ... (tile t is row tile t / nchunks, chunk t % nchunks), so the
// CTAs at work always cover one compact band of rows and each B row is
// read from device memory about once (the stencil's reuse distance, 2 x
// 10,921 rows, stays inside the 50 MB L2). The steps (tile, window) run
// through a two-stage ring: the next step's copies fly during this step's
// FMAs. A thread's copies walk fixed strides (one 16-byte lane of every
// R / kTR-th row, one vector of every few diagonals), so a copy costs a
// few instructions, not a division and a 64-bit product.
//   Thread (g, l) owns rows kTR g .. kTR g + kTR - 1 (kTR = 8) of the tile
// and the 16 bytes of columns 16l .. 16l + 15 of the chunk, with
// kTR x (16 / sizeof(T)) sums in registers. A run of C consecutive offsets
// p, p + 1, ... (positions in the window's stage) needs staged rows
// kTR g + p + u, u < C + kTR - 1: each is read once with a 16-byte shared
// load and multiplied into every (row a, offset k = u - a) it meets, and
// the run's values come in 16-byte loads. (16 rows a thread ran no faster.)
//   What bounds the design: staging moves 1.46 GB for the stencil in f32
// (B 4.23x and the values twice, one per column chunk), through L2 into
// shared memory, and the FMA loop reads C + 7 staged B rows of 16 bytes
// for the 8 C row-offset pairs of a run; the two overlap only partly at
// one CTA an SM (PERF.md §6).
// Each sum takes its offsets in increasing order, the order the plain
// version sums in; the accumulation dtype is f32 for the f32 and bf16
// diagonals and f64 for f64.
//
// Instances (plain C entry points, bound with ctypes):
//   spmm_diag_f32  : dvals f32,  B f32, C f32, R = 512
//   spmm_diag_bf16 : dvals bf16, B f32, C f32 (f32 accumulation: the mixed mode), R = 512
//   spmm_diag_f64  : dvals f64,  B f64, C f64, R = 384
// Each takes the schedule table and its window count in place of the
// offsets, launches on the given stream, does not synchronise, allocates
// nothing, and returns the CUDA error of the attribute calls or the launch
// (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 8;      // column lanes: 8 x 16 bytes = one 128-byte chunk of a B row
constexpr int kStages = 2;     // the ring's stages (kernels/spmm_diag.py STAGES)
constexpr int kTR = 8;         // rows a thread owns (a multiple of 8; 4 and 16 ran slower)
constexpr int kRunMax = 4;     // offsets of one run
constexpr int kWinCols = 6;    // a window's table entries: o_first, d0, nd, span, run_lo, run_hi
constexpr int kRunCols = 3;    // a run's: first offset within the window, length, position

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes, of which the first `bytes` come from src and the rest are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one element, zero where `in` is false: cp.async for 4 and 8 bytes, a
// plain load and store for bf16 (cp.async copies no 2-byte element)
__device__ __forceinline__ void copy_elem(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void copy_elem(double* dst, const double* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void copy_elem(__nv_bfloat16* dst, const __nv_bfloat16* src, bool in) {
  *dst = in ? *src : __ushort_as_bfloat16(0);
}

// the 8 staged values at p (16-byte aligned), widened to the sum's dtype
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const double* p, double (&v)[8]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double2 a = *reinterpret_cast<const double2*>(p + 2 * k);
    v[2 * k] = a.x;
    v[2 * k + 1] = a.y;
  }
}
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load16(const double* p, double (&v)[2]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
struct Cfg {
  static constexpr int V = 16 / sizeof(T);  // columns a thread owns
  static constexpr int KC = kLanes * V;     // columns a CTA tile owns
};
// threads of a CTA whose tile has R rows
template <int R>
__host__ __device__ constexpr int threads_of() { return R / kTR * kLanes; }
static_assert(kTR % 8 == 0, "a thread's values load 8 at a time");

struct Geom {
  int64_t m, n, K;
  int nchunks, bvec, vvec;
};

// Stage window w of tile `tile` at st: values vs[nd][R], then the B rows
// bs[R + span][KC] of rows i0 + o_first + t.
template <typename DV, typename T, int R>
__device__ __forceinline__ void stage(unsigned char* st, const DV* __restrict__ dvals, const T* __restrict__ B,
                                      const int64_t* __restrict__ wtab, int64_t tile, const Geom& g) {
  constexpr int V = Cfg<T>::V, KC = Cfg<T>::KC;
  const int64_t o0 = wtab[0], d0 = wtab[1];
  const int nd = static_cast<int>(wtab[2]), span = static_cast<int>(wtab[3]);
  const int64_t i0 = (tile / g.nchunks) * R;
  const int64_t k0 = (tile % g.nchunks) * KC;
  const int tid = threadIdx.x;
  DV* vs = reinterpret_cast<DV*>(st);
  T* bs = reinterpret_cast<T*>(st + static_cast<size_t>(nd) * R * sizeof(DV));
  constexpr int NT = threads_of<R>();
  if (g.vvec) {
    // thread tid copies vector (tid % per) of diagonals tid / per, + NT / per, ...
    constexpr int VV = 16 / sizeof(DV);
    constexpr int per = R / VV;  // vectors of one diagonal's R values
    static_assert(NT % per == 0, "a pass of the CTA copies whole diagonals");
    constexpr int kDiagStep = NT / per;
    const int s = (tid % per) * VV;
    const int64_t i = i0 + s;
    const int bytes = i < g.m ? static_cast<int>((g.m - i < VV ? g.m - i : VV) * sizeof(DV)) : 0;
    int64_t off = (d0 + tid / per) * g.m + i;
    for (int dd = tid / per; dd < nd; dd += kDiagStep, off += kDiagStep * g.m)
      cp_async16(vs + dd * R + s, bytes ? dvals + off : dvals, bytes);
  } else {
    for (int e = tid; e < nd * R; e += NT) {
      const int dd = e / R, s = e - dd * R;
      const int64_t i = i0 + s;
      copy_elem(vs + e, i < g.m ? dvals + (d0 + dd) * g.m + i : dvals, i < g.m);
    }
  }
  const int rows = R + span;
  if (g.bvec) {
    // thread tid copies the 16 bytes at lane tid % kLanes of rows tid / kLanes, + R / kLanes, ...
    constexpr int kStep = NT / kLanes;
    const int64_t col = k0 + (tid % kLanes) * V;
    int64_t br = i0 + o0 + tid / kLanes, off = br * g.K + col;
    T* dst = bs + (tid / kLanes) * KC + (tid % kLanes) * V;
    for (int t = tid / kLanes; t < rows; t += kStep, br += kStep, off += kStep * g.K, dst += kStep * KC) {
      const bool in = br >= 0 && br < g.n && col < g.K;
      cp_async16(dst, in ? B + off : B, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < rows * KC; e += NT) {
      const int t = e / KC, c = e - t * KC;
      const int64_t br = i0 + o0 + t, col = k0 + c;
      const bool in = br >= 0 && br < g.n && col < g.K;
      copy_elem(bs + e, in ? B + br * g.K + col : B, in);
    }
  }
}

// One run of C consecutive offsets (the window's values from dd on, staged
// rows from position p on) into the thread's 8 x V sums.
template <int C, typename DV, typename T, int R>
__device__ __forceinline__ void run(const DV* vs, const T* bs, int dd, int p, int gr, int lane,
                                    T (&acc)[kTR][Cfg<T>::V]) {
  constexpr int V = Cfg<T>::V, KC = Cfg<T>::KC;
  T val[C][kTR];
#pragma unroll
  for (int k = 0; k < C; ++k)
#pragma unroll
    for (int h = 0; h < kTR; h += 8) {
      T v8[8];
      load8(vs + (dd + k) * R + gr + h, v8);
#pragma unroll
      for (int a = 0; a < 8; ++a) val[k][h + a] = v8[a];
    }
  const T* b0 = bs + (gr + p) * KC + lane * V;
#pragma unroll
  for (int u = 0; u < C + kTR - 1; ++u) {
    T b[V];
    load16(b0 + u * KC, b);
#pragma unroll
    for (int a = 0; a < kTR; ++a) {
      const int k = u - a;
      if (k >= 0 && k < C) {
#pragma unroll
        for (int q = 0; q < V; ++q) acc[a][q] = mul_add(val[k][a], b[q], acc[a][q]);
      }
    }
  }
}

template <typename DV, typename T, int R>
__global__ void __launch_bounds__(threads_of<R>())
spmm_diag_kernel(const DV* __restrict__ dvals, const int64_t* __restrict__ tab, int nwin,
                 const T* __restrict__ B, T* __restrict__ C, Geom g, int64_t ntiles, int stage_bytes) {
  constexpr int V = Cfg<T>::V, KC = Cfg<T>::KC;
  extern __shared__ __align__(128) unsigned char diag_smem[];
  const int64_t* runs = tab + static_cast<int64_t>(nwin) * kWinCols;
  const int tid = threadIdx.x;
  const int gr = (tid / kLanes) * kTR, lane = tid % kLanes;
  const int64_t my_tiles = (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int64_t nsteps = my_tiles * nwin;

  T acc[kTR][V];
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nsteps)
      stage<DV, T, R>(diag_smem + k * stage_bytes, dvals, B, tab + (k % nwin) * kWinCols,
                      blockIdx.x + (k / nwin) * gridDim.x, g);
    cp_async_commit();
  }
  for (int64_t s = 0; s < nsteps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s landed; every thread is done with step s - 1, whose buffer is next
    const int64_t sn = s + kStages - 1;
    if (sn < nsteps)
      stage<DV, T, R>(diag_smem + (sn % kStages) * stage_bytes, dvals, B, tab + (sn % nwin) * kWinCols,
                      blockIdx.x + (sn / nwin) * gridDim.x, g);
    cp_async_commit();
    const int w = static_cast<int>(s % nwin);
    const int64_t tile = blockIdx.x + (s / nwin) * gridDim.x;
    if (w == 0) {
#pragma unroll
      for (int a = 0; a < kTR; ++a)
#pragma unroll
        for (int q = 0; q < V; ++q) acc[a][q] = static_cast<T>(0);
    }
    const int64_t* wt = tab + w * kWinCols;
    const int nd = static_cast<int>(wt[2]);
    const unsigned char* st = diag_smem + (s % kStages) * stage_bytes;
    const DV* vs = reinterpret_cast<const DV*>(st);
    const T* bs = reinterpret_cast<const T*>(st + static_cast<size_t>(nd) * R * sizeof(DV));
    for (int64_t r = wt[4]; r < wt[5]; ++r) {
      const int dd = static_cast<int>(runs[r * kRunCols]);
      const int c = static_cast<int>(runs[r * kRunCols + 1]);
      const int p = static_cast<int>(runs[r * kRunCols + 2]);
      switch (c) {
        case 1: run<1, DV, T, R>(vs, bs, dd, p, gr, lane, acc); break;
        case 2: run<2, DV, T, R>(vs, bs, dd, p, gr, lane, acc); break;
        case 3: run<3, DV, T, R>(vs, bs, dd, p, gr, lane, acc); break;
        default: run<kRunMax, DV, T, R>(vs, bs, dd, p, gr, lane, acc); break;
      }
    }
    if (w == nwin - 1) {
      const int64_t i0 = (tile / g.nchunks) * R + gr;
      const int64_t c0 = (tile % g.nchunks) * KC + lane * V;
      const bool cvec = g.K % V == 0 && c0 < g.K;
#pragma unroll
      for (int a = 0; a < kTR; ++a) {
        const int64_t i = i0 + a;
        if (i >= g.m) break;
        if (cvec) {
          store16(C + i * g.K + c0, acc[a]);
        } else {
#pragma unroll
          for (int q = 0; q < V; ++q)
            if (c0 + q < g.K) C[i * g.K + c0 + q] = acc[a][q];
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <typename DV, typename T, int R>
int launch(const void* dvals, const void* tab, int64_t nwin, const void* B, void* C, int64_t m, int64_t n,
           int64_t K, int64_t stage_bytes, void* stream) {
  if (m <= 0 || K <= 0 || nwin <= 0) return 0;
  constexpr int V = Cfg<T>::V, KC = Cfg<T>::KC;
  const int smem = static_cast<int>(kStages * stage_bytes);
  auto kern = spmm_diag_kernel<DV, T, R>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, nsm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads_of<R>(), smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  Geom g;
  g.m = m;
  g.n = n;
  g.K = K;
  g.nchunks = static_cast<int>((K + KC - 1) / KC);
  g.bvec = K % V == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  g.vvec = (m * static_cast<int64_t>(sizeof(DV))) % 16 == 0 && reinterpret_cast<uintptr_t>(dvals) % 16 == 0;
  const int64_t ntiles = (m + R - 1) / R * g.nchunks;
  const int64_t grid = ntiles < static_cast<int64_t>(nsm) * per_sm ? ntiles : static_cast<int64_t>(nsm) * per_sm;
  kern<<<static_cast<unsigned>(grid), threads_of<R>(), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const DV*>(dvals), static_cast<const int64_t*>(tab), static_cast<int>(nwin),
      static_cast<const T*>(B), static_cast<T*>(C), g, ntiles, static_cast<int>(stage_bytes));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int spmm_diag_f32(const void* dvals, const void* tab, int64_t nwin, const void* B, void* C, int64_t m, int64_t n,
                  int64_t K, int64_t stage_bytes, void* stream) {
  return launch<float, float, 512>(dvals, tab, nwin, B, C, m, n, K, stage_bytes, stream);
}

int spmm_diag_bf16(const void* dvals, const void* tab, int64_t nwin, const void* B, void* C, int64_t m, int64_t n,
                   int64_t K, int64_t stage_bytes, void* stream) {
  return launch<__nv_bfloat16, float, 512>(dvals, tab, nwin, B, C, m, n, K, stage_bytes, stream);
}

int spmm_diag_f64(const void* dvals, const void* tab, int64_t nwin, const void* B, void* C, int64_t m, int64_t n,
                  int64_t K, int64_t stage_bytes, void* stream) {
  return launch<double, double, 384>(dvals, tab, nwin, B, C, m, n, K, stage_bytes, stream);
}

}  // extern "C"
