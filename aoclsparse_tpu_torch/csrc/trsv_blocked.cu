// Blocked triangular solve chain for NVIDIA Hopper (sm_90a): the solve of
// the planner's `dwin` (diagonal window) and `gather` (padded-ELL) TrsvForms
// with pre-inverted diagonal blocks, with K right-hand sides (K = 1 for
// trsv). For the row blocks k = 0..nblk-1 of nb rows, in order, blk0 = k*nb:
//
//   dwin:    s_k[r] = sum_d Dv[k, d, r] * x[blk0 - off_d + r]     (r < off_d)
//   gather:  s_k[r] = sum_w Lval[k, r, w] * x[Lind[k, r, w]]
//   then     x_k = Dinv_k (b_k - s_k)
//
// over dinvT (nblk, nb, nb), dinvT[k] = Dinv_k^T, the inverted lower
// triangular diagonal blocks transposed; Dv (nblk, ndg, nb) with the ndg
// ascending offsets off_d (int32); or Lval (nblk, nb, W) and Lind (nblk, nb,
// W) int32; row-major B, X of (nblk*nb, K). A dwin term reads x only left of
// the block and at rows >= 0: its other slots (off_d <= r, an entry inside
// the diagonal block, or a row before 0) hold Dv == 0 and read the zero pad
// or the zero window in the JAX scan, 0 * 0, which the kernel leaves out
// with the same result. Every other slot is multiplied as stored, a zero
// value included, so an Inf or NaN in solved x meets it as in the scan. The
// gather form's block 0 has no left entries (its slots are padding, value 0,
// against the scan's zero x): s_0 = 0.
//
// Stands for the JAX package's XLA scans (no Pallas kernel there):
//   aoclsparse_tpu/kernels/xla/trsv.py:103  trsv_blocked_dwin (inv=True)
//   aoclsparse_tpu/kernels/xla/trsv.py:152  trsv_blocked (the inverted-block twin)
// the `inv=True` branch the JAX package takes on its accelerator
// (planner/triangular.py:211-226 there); the port's `win` solve takes it too.
//
// What bounds it: each block depends on the block before it (the stencil's
// offset 1), so the solve is a chain of nblk dependent steps. The bytes it
// needs (dinvT's triangles, Dv or Lval/Lind, b and x once; 0.646 GB at the
// 104^3 stencil, nb = 256, f32: 0.193 ms at 3.35 TB/s) are far below what
// the step latency costs: a step reads the previous step's x, and every
// step is at least a few dependent memory round trips and CTA barriers.
//
// Design, simple first: one CTA a chunk of KC columns (1, 2 or 4) walks all
// blocks; the chunks' chains run side by side on their own SMs. A CTA has
// G * rp threads (rp = nb rounded up to a warp, G = min(16, 1024 / rp)
// slices). Thread (g, r) owns row r of a step and slice g of its sums:
//   1. the left sum over diagonals d = g, g + G, ... (dwin) or ELL slots
//      w = g, g + G, ... (gather), reading solved x from device memory (it
//      was written by the same CTA one or more steps before, visible after
//      the step's last barrier, and stays in L1/L2); the slices meet in
//      shared memory in slice order and row r's rhs = b - s goes to shared
//      memory;
//   2. x[r] = sum over q <= r of dinvT[k][q][r] * rhs[q], q = g, g + G, ...:
//      dinvT's upper triangle only (Dinv_k is lower triangular), each load
//      coalesced across r and serving KC sums held in registers; the
//      slices meet in slice order and row r of x goes to device memory.
// Four CTA barriers a step. The window of the dwin form is read from device
// memory, not kept in shared memory, so neither WL (up to 65,536 rows) nor
// KC is capped by shared memory: at the 104^3 stencil a shared window of
// (WL + nb) * KC values would take 179 KB f32 at KC = 4. Each step asks L2
// for the operands of the step kPrefetch ahead (prefetch.global.L2 over the
// triangle's rows, Dv or Lval/Lind, and b), which the chain does not wait
// for.
//
// Tried on the card and dropped, each no faster on the 104^3 stencil:
// staging a step's operands (the triangle, the left operand, b, the far x)
// in shared memory by cp.async one step ahead; a ring of up to 8 such
// stages; 256 threads in place of 1024. Switching parts of a step off put
// most of it in moving the step's operands into the one SM, however they
// moved: the chain is bound by what one SM can pull in a step, and the
// way past it is to split a step across SMs (ROADMAP.md, Hopper work).
//
// Every sum runs in the operand dtype in a fixed order (no atomics): the
// same inputs give the same bits. The order differs from the scan's, within
// the dtype's model tolerance. Rows of dinvT_k below its diagonal are never
// read: a non-finite rhs value in row q of a block leaves the block's rows
// r < q as a triangular solve gives them, where the scan's dense product
// (0 * Inf) gives NaN, as in the window solves (csrc/trsv_win.cu).
//
// Instances (plain C entry points, bound with ctypes):
//   trsv_blocked_f32, trsv_blocked_f64
// mode 0 = dwin (aux = the ndg offsets), 1 = gather (aux = Lind). Each launches one
// kernel on the given stream, does not synchronise, allocates nothing,
// adds 1 to *launches, and returns the first CUDA error of the attribute
// call or the launch (0 on success; cudaErrorInvalidValue for arguments
// out of range).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSlices = 16;
// steps ahead whose operands a step asks L2 for
constexpr int kPrefetch = 2;

enum Mode { kDwin = 0, kGather = 1 };

__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }

__host__ __device__ constexpr int64_t round_up(int64_t v, int64_t m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// ask L2 for n contiguous elements of E from p, one request a 128-byte line
template <typename E>
__device__ __forceinline__ void prefetch_span(const E* p, int64_t n) {
  constexpr int kLine = 128 / static_cast<int>(sizeof(E));
  for (int64_t i = static_cast<int64_t>(threadIdx.x) * kLine; i < n; i += static_cast<int64_t>(blockDim.x) * kLine)
    prefetch_l2(p + i);
}

// the operands of step k: dinvT[k]'s upper triangle (row q from column q),
// the step's left operand and its b rows
template <typename T, int MODE>
__device__ __forceinline__ void prefetch_step(const T* dinvT, const T* Lv, const int32_t* aux, const T* B, int64_t k,
                                              int nb, int nw, int K) {
  constexpr int kLine = 128 / static_cast<int>(sizeof(T));
  const int lpr = (nb + kLine - 1) / kLine;
  const T* dk = dinvT + k * nb * nb;
  for (int i = threadIdx.x; i < nb * lpr; i += blockDim.x) {
    const int q = i / lpr;
    const int l = i - q * lpr;
    if ((l + 1) * kLine > q) prefetch_l2(dk + static_cast<int64_t>(q) * nb + l * kLine);
  }
  const int64_t nl = static_cast<int64_t>(nb) * nw;
  prefetch_span(Lv + k * nl, nl);
  if (MODE == kGather) prefetch_span(aux + k * nl, nl);
  prefetch_span(B + k * nb * K, static_cast<int64_t>(nb) * K);
}

template <typename T, int MODE, int KC>
__global__ void __launch_bounds__(kMaxThreads, 1)
    trsv_blocked_kernel(const T* __restrict__ dinvT, const T* __restrict__ Lv, const int32_t* __restrict__ aux,
                        const T* __restrict__ B, T* X, int nblk, int nb, int nw, int K, int G, int offs_pad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* offs = reinterpret_cast<int*>(smem_raw);
  const int nt = blockDim.x;
  const int rp = nt / G;
  const int t = threadIdx.x;
  const int g = t / rp;
  const int r = t - g * rp;
  const bool row = r < nb;
  const int col0 = blockIdx.x * KC;
  const int kc = min(KC, K - col0);
  // red: KC x G x rp partial sums, rhs: KC x rp (column-major over c, so a
  // warp's neighbouring rows touch neighbouring words)
  T* red = reinterpret_cast<T*>(smem_raw + offs_pad);
  T* rhs = red + KC * nt;
  if (MODE == kDwin)
    for (int i = t; i < nw; i += nt) offs[i] = aux[i];
  for (int k = 0; k < min(kPrefetch, nblk); ++k) prefetch_step<T, MODE>(dinvT, Lv, aux, B, k, nb, nw, K);
  __syncthreads();

  for (int k = 0; k < nblk; ++k) {
    if (k + kPrefetch < nblk) prefetch_step<T, MODE>(dinvT, Lv, aux, B, k + kPrefetch, nb, nw, K);
    const int64_t blk0 = static_cast<int64_t>(k) * nb;
    T bv[KC], s[KC], a[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      bv[c] = T(0);
      s[c] = T(0);
      a[c] = T(0);
    }
    if (g == 0 && row) {
#pragma unroll
      for (int c = 0; c < KC; ++c)
        if (c < kc) bv[c] = B[(blk0 + r) * K + col0 + c];
    }
    // 1. the left sum, slice g
    if (row) {
      if (MODE == kDwin) {
        const T* dv = Lv + blk0 * nw + r;
        for (int d = g; d < nw; d += G) {
          const int off = offs[d];
          const int64_t src = blk0 - off + r;
          if (r < off && src >= 0) {
            const T v = dv[static_cast<int64_t>(d) * nb];
            const T* xr = X + src * K + col0;
#pragma unroll
            for (int c = 0; c < KC; ++c)
              if (c < kc) s[c] = mul_add(v, xr[c], s[c]);
          }
        }
      } else if (k > 0) {
        const int64_t base = (blk0 + r) * nw;
        for (int w = g; w < nw; w += G) {
          const T v = Lv[base + w];
          const T* xr = X + static_cast<int64_t>(aux[base + w]) * K + col0;
#pragma unroll
          for (int c = 0; c < KC; ++c)
            if (c < kc) s[c] = mul_add(v, xr[c], s[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) red[(c * G + g) * rp + r] = s[c];
    __syncthreads();
    if (g == 0 && row) {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        T acc = red[c * G * rp + r];
        for (int gg = 1; gg < G; ++gg) acc += red[(c * G + gg) * rp + r];
        rhs[c * rp + r] = bv[c] - acc;
      }
    }
    __syncthreads();
    // 2. x = Dinv_k rhs over dinvT's upper triangle, slice g
    if (row) {
      const T* dt = dinvT + blk0 * nb + r;
#pragma unroll 4
      for (int q = g; q <= r; q += G) {
        const T v = dt[static_cast<int64_t>(q) * nb];
#pragma unroll
        for (int c = 0; c < KC; ++c) a[c] = mul_add(v, rhs[c * rp + q], a[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) red[(c * G + g) * rp + r] = a[c];
    __syncthreads();
    if (g == 0 && row) {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        T acc = red[c * G * rp + r];
        for (int gg = 1; gg < G; ++gg) acc += red[(c * G + gg) * rp + r];
        if (c < kc) X[(blk0 + r) * K + col0 + c] = acc;
      }
    }
    __syncthreads();  // x_k is visible to the next steps' reads
  }
}

template <typename T, int MODE, int KC>
int launch_kc(const void* dinvT, const void* Lv, const void* aux, const void* B, void* X, int64_t nblk, int64_t nb,
              int64_t nw, int64_t K, cudaStream_t stream, int64_t* launches) {
  const int rp = static_cast<int>(round_up(nb, 32));
  const int G = max(1, min(kMaxSlices, kMaxThreads / rp));
  const int threads = G * rp;
  const int offs_pad = MODE == kDwin ? static_cast<int>(round_up(nw * 4, 16)) : 0;
  const size_t smem = offs_pad + sizeof(T) * KC * static_cast<size_t>(threads + rp);
  auto kern = trsv_blocked_kernel<T, MODE, KC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>((K + KC - 1) / KC);
  kern<<<grid, threads, smem, stream>>>(static_cast<const T*>(dinvT), static_cast<const T*>(Lv),
                                        static_cast<const int32_t*>(aux), static_cast<const T*>(B),
                                        static_cast<T*>(X), static_cast<int>(nblk), static_cast<int>(nb),
                                        static_cast<int>(nw), static_cast<int>(K), G, offs_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  *launches += 1;
  return 0;
}

template <typename T, int MODE>
int launch_mode(const void* dinvT, const void* Lv, const void* aux, const void* B, void* X, int64_t nblk, int64_t nb,
                int64_t nw, int64_t K, int64_t KC, cudaStream_t stream, int64_t* launches) {
  switch (KC) {
    case 1: return launch_kc<T, MODE, 1>(dinvT, Lv, aux, B, X, nblk, nb, nw, K, stream, launches);
    case 2: return launch_kc<T, MODE, 2>(dinvT, Lv, aux, B, X, nblk, nb, nw, K, stream, launches);
    case 4: return launch_kc<T, MODE, 4>(dinvT, Lv, aux, B, X, nblk, nb, nw, K, stream, launches);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(int64_t mode, const void* dinvT, const void* Lv, const void* aux, const void* B, void* X, int64_t nblk,
           int64_t nb, int64_t nw, int64_t K, int64_t KC, void* stream, int64_t* launches) {
  if (nblk < 1 || nblk > INT32_MAX || nb < 1 || nb > kMaxThreads || nw < 1 || nw > 1 << 20 || K < 1 || K > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kDwin) return launch_mode<T, kDwin>(dinvT, Lv, aux, B, X, nblk, nb, nw, K, KC, st, launches);
  if (mode == kGather) return launch_mode<T, kGather>(dinvT, Lv, aux, B, X, nblk, nb, nw, K, KC, st, launches);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int trsv_blocked_f32(int64_t mode, const void* dinvT, const void* Lv, const void* aux, const void* B, void* X,
                     int64_t nblk, int64_t nb, int64_t nw, int64_t K, int64_t KC, void* stream, int64_t* launches) {
  return launch<float>(mode, dinvT, Lv, aux, B, X, nblk, nb, nw, K, KC, stream, launches);
}

int trsv_blocked_f64(int64_t mode, const void* dinvT, const void* Lv, const void* aux, const void* B, void* X,
                     int64_t nblk, int64_t nb, int64_t nw, int64_t K, int64_t KC, void* stream, int64_t* launches) {
  return launch<double>(mode, dinvT, Lv, aux, B, X, nblk, nb, nw, K, KC, stream, launches);
}

}  // extern "C"
