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
// Multi-RHS solve (trsm_win), the same recurrence with K right-hand sides:
//
//     X_k = dinvT_k^T . (B_k - lwT_k^T . W),   W <- [W; X_k][-WL:],   W_0 = 0
//
// for row-major B and X of (nblk*nb, K). Replaces
// aoclsparse_tpu/kernels/pallas/trsv.py:160 pallas_trsm_win_inv (whose Bt is
// B transposed per block, with K padded to 8; neither is needed here). The
// RHS columns are independent, so a grid of CTAs splits them into chunks of
// KC columns, one CTA each, and each CTA walks all nblk blocks in order as
// the single-RHS kernel does. Thread r owns row r and keeps KC sums in
// registers, so each loaded element of lwT_k and dinvT_k serves KC columns
// (the single-RHS kernel pays one load per FMA). Those operand loads are
// the chain's latency, so each thread keeps the next kPB of them in flight
// while it computes with the current kPB. The window is a circular buffer
// of WL rows of KC values in dynamic shared memory and b_k - s is staged as
// nb such rows; every thread reads the same row at once (a broadcast), in
// 16-byte vectors where KC allows, rows padded to a 16-byte multiple. The
// wrapper picks KC in {16, 8, 4, 2, 1}, as large as K asks and the rows fit
// the 227 KB a block may use; nb is at most 512 (kTrsmThreads), so a
// thread has the registers for its KC sums and the prefetched loads.
// Bound: the chain of nblk steps, as for one RHS; at K = 16 a step also
// does 16x the FMAs, 320 * 16 per thread on the ILU0 factors of the bench
// operand, fed by one shared-memory vector load per 4 (f32) or 2 (f64).
//
// Instances (plain C entry points, bound with ctypes):
//   trsv_win_f32, trsm_win_f32 : float32 operands
//   trsv_win_f64, trsm_win_f64 : float64 operands
// Each launches on the given stream, does not synchronise, allocates
// nothing, and returns the CUDA error of the attribute call or the launch
// (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

constexpr int kTrsmThreads = 512;
constexpr int kPB = 8;  // operand loads a thread keeps in flight

// shared-memory row stride of the multi-RHS kernel, in values: KC padded
// to a 16-byte multiple plus one 16-byte vector (writes of neighbouring
// rows spread over the banks); scalar rows when KC is below one vector
template <typename T, int KC>
__host__ __device__ constexpr int row_stride() {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  return KC >= V ? KC + V : (KC > 1 ? KC + 1 : 1);
}

// KC values of a shared-memory row to registers and back, in 16-byte
// vectors where the row allows
__device__ __forceinline__ void unpack(float4 x, float* v) { v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w; }
__device__ __forceinline__ void unpack(double2 x, double* v) { v[0] = x.x; v[1] = x.y; }
__device__ __forceinline__ float4 pack(const float* v) { return make_float4(v[0], v[1], v[2], v[3]); }
__device__ __forceinline__ double2 pack(const double* v) { return make_double2(v[0], v[1]); }

template <typename T, int KC>
__device__ __forceinline__ void load_row(const T* p, T* v) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if constexpr (KC >= V) {
    using Vec = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
#pragma unroll
    for (int i = 0; i < KC / V; ++i) unpack(reinterpret_cast<const Vec*>(p)[i], v + i * V);
  } else {
#pragma unroll
    for (int c = 0; c < KC; ++c) v[c] = p[c];
  }
}

template <typename T, int KC>
__device__ __forceinline__ void store_row(T* p, const T* v) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if constexpr (KC >= V) {
    using Vec = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
#pragma unroll
    for (int i = 0; i < KC / V; ++i) reinterpret_cast<Vec*>(p)[i] = pack(v + i * V);
  } else {
#pragma unroll
    for (int c = 0; c < KC; ++c) p[c] = v[c];
  }
}

// acc[c] += sum_{t < len} rows[slot(t)][c] * op[t * nb], where slot(t) is
// row(t) of the caller: the operand column (lwT_k or dinvT_k, stride nb)
// streams from device memory kPB values ahead of the arithmetic
template <typename T, int KC, typename Row>
__device__ __forceinline__ void accumulate(T* acc, const T* __restrict__ op, int len, int nb, Row row) {
  T cur[kPB], nxt[kPB];
#pragma unroll
  for (int i = 0; i < kPB; ++i) cur[i] = i < len ? op[static_cast<int64_t>(i) * nb] : static_cast<T>(0);
  for (int t0 = 0; t0 < len; t0 += kPB) {
#pragma unroll
    for (int i = 0; i < kPB; ++i) {
      const int t = t0 + kPB + i;
      nxt[i] = t < len ? op[static_cast<int64_t>(t) * nb] : static_cast<T>(0);
    }
#pragma unroll
    for (int i = 0; i < kPB; ++i) {
      if (t0 + i < len) {
        T v[KC];
        load_row<T, KC>(row(t0 + i), v);
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[c] = mul_add(v[c], cur[i], acc[c]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPB; ++i) cur[i] = nxt[i];
  }
}

template <typename T, int KC>
__global__ void __launch_bounds__(kTrsmThreads)
trsm_win_kernel(const T* __restrict__ dinvT, const T* __restrict__ lwT, const T* __restrict__ B,
                T* __restrict__ X, int64_t nblk, int nb, int WL, int64_t K) {
  constexpr int KCP = row_stride<T, KC>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w = reinterpret_cast<T*>(smem_raw);  // WL rows: circular window of solved X
  T* rhs = w + WL * KCP;                   // nb rows: B_k - s

  const int r = threadIdx.x;
  const bool active = r < nb;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * KC;
  const int kc = static_cast<int>(K - c0 < KC ? K - c0 : KC);  // live columns of this chunk
  for (int t = r; t < WL * KCP; t += blockDim.x) w[t] = static_cast<T>(0);
  __syncthreads();

  const int64_t nb64 = nb;
  for (int64_t k = 0; k < nblk; ++k) {
    const int64_t blk0 = k * nb64;
    // window position t holds X[blk0 - WL + t, :], kept at slot (head + t) % WL
    const int head = static_cast<int>(blk0 % WL);
    if (active) {
      T s[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) s[c] = static_cast<T>(0);
      accumulate<T, KC>(s, lwT + k * WL * nb64 + r, WL, nb, [&](int t) {
        const int slot = t < WL - head ? head + t : t - (WL - head);
        return w + slot * KCP;
      });
      const T* bk = B + (blk0 + r) * K + c0;
#pragma unroll
      for (int c = 0; c < KC; ++c) s[c] = (c < kc ? bk[c] : static_cast<T>(0)) - s[c];
      store_row<T, KC>(rhs + r * KCP, s);
    }
    __syncthreads();  // rhs complete; every read of w for this step done
    if (active) {
      T xr[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) xr[c] = static_cast<T>(0);
      accumulate<T, KC>(xr, dinvT + k * nb64 * nb64 + r, nb, nb, [&](int q) { return rhs + q * KCP; });
      T* xk = X + (blk0 + r) * K + c0;
#pragma unroll
      for (int c = 0; c < KC; ++c)
        if (c < kc) xk[c] = xr[c];
      // only the last WL rows of the block stay in the window
      if (r >= nb - WL) store_row<T, KC>(w + ((head + r) % WL) * KCP, xr);
    }
    __syncthreads();  // window updated; rhs free for the next step
  }
}

template <typename T, int KC>
int launch_trsm_kc(const void* dinvT, const void* lwT, const void* B, void* X, int64_t nblk,
                   int64_t nb, int64_t WL, int64_t K, void* stream) {
  if (nb > kTrsmThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = static_cast<int>((nb + 31) / 32 * 32);
  const size_t smem = static_cast<size_t>(WL + nb) * row_stride<T, KC>() * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(trsm_win_kernel<T, KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned chunks = static_cast<unsigned>((K + KC - 1) / KC);
  trsm_win_kernel<T, KC><<<chunks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dinvT), static_cast<const T*>(lwT), static_cast<const T*>(B),
      static_cast<T*>(X), nblk, static_cast<int>(nb), static_cast<int>(WL), K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_trsm(const void* dinvT, const void* lwT, const void* B, void* X, int64_t nblk,
                int64_t nb, int64_t WL, int64_t K, int64_t KC, void* stream) {
  if (nblk <= 0 || K <= 0) return 0;
  switch (KC) {
    case 16: return launch_trsm_kc<T, 16>(dinvT, lwT, B, X, nblk, nb, WL, K, stream);
    case 8: return launch_trsm_kc<T, 8>(dinvT, lwT, B, X, nblk, nb, WL, K, stream);
    case 4: return launch_trsm_kc<T, 4>(dinvT, lwT, B, X, nblk, nb, WL, K, stream);
    case 2: return launch_trsm_kc<T, 2>(dinvT, lwT, B, X, nblk, nb, WL, K, stream);
    case 1: return launch_trsm_kc<T, 1>(dinvT, lwT, B, X, nblk, nb, WL, K, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

int trsm_win_f32(const void* dinvT, const void* lwT, const void* B, void* X, int64_t nblk,
                 int64_t nb, int64_t WL, int64_t K, int64_t KC, void* stream) {
  return launch_trsm<float>(dinvT, lwT, B, X, nblk, nb, WL, K, KC, stream);
}

int trsm_win_f64(const void* dinvT, const void* lwT, const void* B, void* X, int64_t nblk,
                 int64_t nb, int64_t WL, int64_t K, int64_t KC, void* stream) {
  return launch_trsm<double>(dinvT, lwT, B, X, nblk, nb, WL, K, KC, stream);
}

}  // extern "C"
