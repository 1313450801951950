// Blocked window triangular solve for NVIDIA Hopper (sm_90a), the solve of
// the planner's `win` TrsvForm with pre-inverted diagonal blocks:
//
//     x_k = (b_k - w . lwT_k) . dinvT_k,    w <- [w, x_k][-WL:],   w_0 = 0
//
// for blocks k = 0..nblk-1 of nb rows each, in row-vector form over the
// JAX package's transposed operands: dinvT (nblk, nb, nb) with
// dinvT[k] = Dinv_k^T, lwT (nblk, WL, nb) with lwT[k] = Lwin_k^T, and b, x
// of nblk*nb values. w holds the WL solved values x[blk0 - WL, blk0) that
// end at the block's first row (zeros before row 0). WL may exceed nb: the
// window then reaches back over several blocks, the semantics of
// kernels/xla/trsv.py:72-99.
//
// Replaces two TPU kernels of the JAX package, one contract:
//   aoclsparse_tpu/kernels/pallas/trsv.py:74   pallas_trsv_win_inv8 (8 blocks a step)
//   aoclsparse_tpu/kernels/pallas/trsv.py:114  pallas_trsv_win_inv  (1 block a step)
// Their 8-block grouping, the identity padding of nblk to a multiple of 8
// and the (8, nb/8) lane layout of vectors are TPU layout with no
// counterpart here: this kernel walks the nblk blocks as they are.
//
// What bounds it: the blocks depend on each other through w, so the solve
// is a chain of nblk steps. Each step streams nb*nb + WL*nb operand values
// once (the ILU0 factors of a 262144-row band: 336 MB per solve at nb = 256,
// WL = 64) at 2 flops per value. On a TPU the grid runs in order on one
// core; on Hopper, blocks of a grid run in no order and share nothing, so
// the carried window needs one block that walks the chain. Latency of that
// one SM's loads bounds it, far below the card's stream rate.
//
// Design (simple and right first; see ROADMAP.md for the faster designs):
// one persistent CTA of round_up(nb, 32) threads. Thread r owns row r of
// every block. Per step, thread r reads lwT[k, t, r] over t and then
// dinvT[k, q, r] over q, both coalesced across r (the JAX package's
// transposed layouts are what make them so). The window lives in
// dynamic shared memory as a circular buffer of WL values (x row g at slot
// g mod WL), so nothing is shifted; b_k - s is staged in shared memory
// between the two products, with __syncthreads between them and at the end
// of the step. Sums run in the operand dtype in increasing index order, as
// the Pallas kernel accumulates (preferred_element_type = operand dtype).
//
// Instances (plain C entry points, bound with ctypes):
//   trsv_win_f32 : float32 operands
//   trsv_win_f64 : float64 operands
// Each launches on the given stream, does not synchronise, allocates
// nothing, and returns the CUDA error of the attribute call or the launch
// (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
trsv_win_kernel(const T* __restrict__ dinvT, const T* __restrict__ lwT,
                const T* __restrict__ b, T* __restrict__ x, int64_t nblk, int nb, int WL) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w = reinterpret_cast<T*>(smem_raw);  // WL: circular window of solved x
  T* rhs = w + WL;                         // nb: b_k - w . lwT_k

  const int r = threadIdx.x;
  const bool active = r < nb;
  for (int t = r; t < WL; t += blockDim.x) w[t] = static_cast<T>(0);
  __syncthreads();

  const int64_t nb64 = nb;
  for (int64_t k = 0; k < nblk; ++k) {
    const int64_t blk0 = k * nb64;
    // window position t holds x[blk0 - WL + t], kept at slot (head + t) % WL
    const int head = static_cast<int>(blk0 % WL);
    if (active) {
      const T* lk = lwT + k * WL * nb64 + r;
      const int n1 = WL - head;
      T s = static_cast<T>(0);
#pragma unroll 16
      for (int t = 0; t < n1; ++t) s = mul_add(w[head + t], lk[static_cast<int64_t>(t) * nb], s);
#pragma unroll 16
      for (int t = n1; t < WL; ++t) s = mul_add(w[t - n1], lk[static_cast<int64_t>(t) * nb], s);
      rhs[r] = b[blk0 + r] - s;
    }
    __syncthreads();  // rhs complete; every read of w for this step done
    if (active) {
      const T* dk = dinvT + k * nb64 * nb64 + r;
      T xr = static_cast<T>(0);
#pragma unroll 16
      for (int q = 0; q < nb; ++q) xr = mul_add(rhs[q], dk[static_cast<int64_t>(q) * nb], xr);
      x[blk0 + r] = xr;
      // only the last WL rows of the block stay in the window
      if (r >= nb - WL) w[(head + r) % WL] = xr;
    }
    __syncthreads();  // window updated; rhs free for the next step
  }
}

template <typename T>
int launch(const void* dinvT, const void* lwT, const void* b, void* x, int64_t nblk,
           int64_t nb, int64_t WL, void* stream) {
  if (nblk <= 0) return 0;
  const int threads = static_cast<int>((nb + 31) / 32 * 32);
  const size_t smem = static_cast<size_t>(WL + nb) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(trsv_win_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  trsv_win_kernel<T><<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dinvT), static_cast<const T*>(lwT), static_cast<const T*>(b),
      static_cast<T*>(x), nblk, static_cast<int>(nb), static_cast<int>(WL));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int trsv_win_f32(const void* dinvT, const void* lwT, const void* b, void* x, int64_t nblk,
                 int64_t nb, int64_t WL, void* stream) {
  return launch<float>(dinvT, lwT, b, x, nblk, nb, WL, stream);
}

int trsv_win_f64(const void* dinvT, const void* lwT, const void* b, void* x, int64_t nblk,
                 int64_t nb, int64_t WL, void* stream) {
  return launch<double>(dinvT, lwT, b, x, nblk, nb, WL, stream);
}

}  // extern "C"
