// CSR SpMM for NVIDIA Hopper (sm_90a), the mm kernel of the `segsum`
// execution form (mm KID 0):
//
//     C[i, :] = sum_{ptr[i] <= p < ptr[i + 1]} val[p] * B[ind[p], :]     (0 <= i < m)
//
// over the planner's CSR (ExecForm.ptr, ind, val), B (n, K) and C (m, K)
// row-major; every ind[p] lies in [0, n), as the planner's validated CSR
// holds it. C is written, never read: one launch computes the whole
// product, and the alpha / beta epilogue stays in ops/level3/csrmm.py.
//
// It replaces no Pallas kernel. It is the hand kernel of the JAX package's
// XLA formulation
//   aoclsparse_tpu/kernels/xla/spmm.py:21  spmm_segsum  (mm KID 0)
// (gather B rows, scale, segment sum), which the port's planner sends
// general structure to on the card (planner/plan.py `choose_mm_format`,
// `mm_kind`): a scattered matrix's CSR moves far fewer bytes than the band
// of the `gen` composite (mm KID 6) and its permutes of B and C, and the
// gather forms (`ell`, `ellhyb`) build an (nnz, K) product tile in plain
// torch.
//
// What bounds it: bytes. The CSR once (nnz * (4 + vsize) with int32
// indices, (m + 1) * 4 row pointers), B once and C once (n * K and m * K
// values) is the least the card must move: 0.0286 ms on the scircuit
// stand-in at K = 64 f32, 0.161 ms on the webbase stand-in. What the
// kernel moves beyond that is B's gathered rows: each entry reads a K-wide
// row of B, nnz * K * vsize bytes (790 MB on webbase at K = 64), from L2
// where B fits its 50 MB (scircuit's 44 MB does), from HBM where it does
// not (webbase's 256 MB). At 2 flops an entry and column it is far below
// the card's flop:byte balance, so what the time depends on is how many
// bytes each SM has in flight.
//
// Design: one launch, grid (blocks of the plan's schedule, column tiles).
// The schedule is the CSR row-gather SpMV kernel's (kernels/spmv_csr.py
// `csr_blocks`, the form's `csr_blocks`: runs of whole rows of at most
// 2,048 entries (1,024 for the wider types) and half as many rows, a row
// past LONG_ROW = 256 entries a block of its own). A column tile is 32
// lanes by a vector of VEC values (8 bytes for float sums where K is even
// and B and C are 8-byte aligned, else one value a lane, the scalar path
// that an odd K takes): 64 f32 columns, 32 of the wider types.
// - A block of several rows: its row pointers go to shared memory, then
//   each of the CTA's 8 warps takes a row in turn. The warp loads the
//   row's (index, value) pairs 32 at a time, coalesced and with the
//   evict-first hint (__ldcs), and broadcasts them by shuffle; each lane
//   reads its columns of B[ind[p], tile] (one coalesced row segment a warp
//   and step, four rows in flight a lane), multiply-adds into registers in
//   entry order, and stores its C tile once (streamed, __stcs).
// - A block of one row (past LONG_ROW, or a row alone): the warps split
//   the row's entries 32 at a time, 256 apart, and meet in shared memory in
//   warp order.
// No atomics: every sum's order is fixed by the structure, so a run
// repeats bit for bit. It is not index_add_'s order, so a comparison with
// the plain version (kernels/spmm_plain.py spmm_segsum) takes the dtype's
// model tolerance. Every stored entry is multiplied, stored zeros
// included, so a zero meeting an Inf of B gives NaN, as the JAX
// spmm_segsum does. B offsets are 64-bit (ind[p] * K passes int32 at
// n * K > 2^31).
//
// Instances (plain C entry points, bound with ctypes), each for int32 or
// int64 row pointers and int32 or int64 column indices:
//   spmm_csr_f32, spmm_csr_f64, spmm_csr_c64 (float2), spmm_csr_c128
//   (double2): val, B and C of the type, the sums in it;
//   spmm_csr_bf16: val bf16, B and C float32, f32 sums (mm widens a bf16
//   handle's B to f32, exactly, as for its band forms).
// Each launches once on the given stream (nothing where the schedule has
// no block or K = 0), does not synchronise, allocates nothing, and returns
// cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // threads a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // B rows in flight a lane
// rows of a block of several rows (csr_blocks: at most 1,024)
constexpr int kMaxRows = 1024;
constexpr unsigned kFull = 0xffffffffu;

// the sum type of a value type: bf16 values sum in f32
template <typename T>
struct Sum {
  using type = T;
};
template <>
struct Sum<__nv_bfloat16> {
  using type = float;
};

__device__ __forceinline__ float uzero(float) { return 0.0f; }
__device__ __forceinline__ double uzero(double) { return 0.0; }
__device__ __forceinline__ float2 uzero(float2) { return make_float2(0.0f, 0.0f); }
__device__ __forceinline__ double2 uzero(double2) { return make_double2(0.0, 0.0); }

// c + a * b
__device__ __forceinline__ float umad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double umad(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float2 umad(float2 a, float2 b, float2 c) {
  c.x = fmaf(a.x, b.x, c.x);
  c.x = fmaf(-a.y, b.y, c.x);
  c.y = fmaf(a.x, b.y, c.y);
  c.y = fmaf(a.y, b.x, c.y);
  return c;
}
__device__ __forceinline__ double2 umad(double2 a, double2 b, double2 c) {
  c.x = fma(a.x, b.x, c.x);
  c.x = fma(-a.y, b.y, c.x);
  c.y = fma(a.x, b.y, c.y);
  c.y = fma(a.y, b.x, c.y);
  return c;
}

__device__ __forceinline__ float uadd(float a, float b) { return a + b; }
__device__ __forceinline__ double uadd(double a, double b) { return a + b; }
__device__ __forceinline__ float2 uadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ double2 uadd(double2 a, double2 b) { return make_double2(a.x + b.x, a.y + b.y); }

__device__ __forceinline__ float ushfl(float v, int src) { return __shfl_sync(kFull, v, src); }
__device__ __forceinline__ double ushfl(double v, int src) { return __shfl_sync(kFull, v, src); }
__device__ __forceinline__ float2 ushfl(float2 v, int src) {
  return make_float2(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src));
}
__device__ __forceinline__ double2 ushfl(double2 v, int src) {
  return make_double2(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src));
}

// a stored value, streamed (evict first), in its sum type
__device__ __forceinline__ float value(const float* p) { return __ldcs(p); }
__device__ __forceinline__ double value(const double* p) { return __ldcs(p); }
__device__ __forceinline__ float2 value(const float2* p) { return __ldcs(p); }
__device__ __forceinline__ double2 value(const double2* p) { return __ldcs(p); }
__device__ __forceinline__ float value(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
}

// VEC values of B's row segment through the read-only path (VEC = 2: one
// 8-byte load of two floats)
template <typename U, int VEC>
__device__ __forceinline__ void load_b(const U* __restrict__ p, U (&b)[VEC]) {
  if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    b[0] = t.x;
    b[1] = t.y;
  } else {
    b[0] = __ldg(p);
  }
}

// a lane's C tile, streamed
template <typename U, int VEC>
__device__ __forceinline__ void store_c(U* __restrict__ p, const U (&a)[VEC]) {
  if constexpr (VEC == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(a[0], a[1]));
  } else {
    __stcs(p, a[0]);
  }
}

// acc += the n (<= 32) entries the warp holds one a lane (lane j: column
// c, value v) times their B rows' tile, in entry order; n is the same for
// the whole warp. `col` is the lane's first column, clamped to 0 for a
// lane past K (it reads column 0 of the same rows and stores nothing), so
// every lane loads and no branch splits the warp
template <typename U, typename I, int VEC>
__device__ __forceinline__ void gather_chunk(I c, U v, int n, const U* __restrict__ B, long long K, long long col,
                                             U (&acc)[VEC]) {
  int j = 0;
  for (; j + kUnroll <= n; j += kUnroll) {
    U vj[kUnroll];
    U b[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const I cj = __shfl_sync(kFull, c, j + u);
      vj[u] = ushfl(v, j + u);
      load_b<U, VEC>(B + static_cast<long long>(cj) * K + col, b[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = umad(vj[u], b[u][i], acc[i]);
    }
  }
  for (; j < n; ++j) {
    const I cj = __shfl_sync(kFull, c, j);
    const U vj = ushfl(v, j);
    U b[VEC];
    load_b<U, VEC>(B + static_cast<long long>(cj) * K + col, b);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = umad(vj, b[i], acc[i]);
  }
}

template <typename T, typename P, typename I, int VEC>
__global__ void __launch_bounds__(kThreads)
spmm_csr_kernel(const P* __restrict__ ptr, const I* __restrict__ ind, const T* __restrict__ val,
                const typename Sum<T>::type* __restrict__ B, typename Sum<T>::type* __restrict__ C,
                const long long* __restrict__ blocks, long long K) {
  using U = typename Sum<T>::type;
  __shared__ int rp[kMaxRows + 1];
  __shared__ U part[kWarps - 1][32 * VEC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long* blk = blocks + 2 * static_cast<long long>(blockIdx.x);
  const long long r0 = __ldg(blk), s = __ldg(blk + 1), r1 = __ldg(blk + 2), e = __ldg(blk + 3);
  const int nr = static_cast<int>(r1 - r0);
  const long long col = static_cast<long long>(blockIdx.y) * (32 * VEC) + lane * VEC;
  const bool active = col < K;
  const long long colc = active ? col : 0;
  U acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = uzero(U());

  if (nr == 1) {  // the same for the whole CTA
    for (long long p0 = s + warp * 32; p0 < e; p0 += kThreads) {
      const long long p = p0 + lane;
      I c = 0;
      U v = uzero(U());
      if (p < e) {
        c = __ldcs(ind + p);
        v = value(val + p);
      }
      gather_chunk<U, I, VEC>(c, v, static_cast<int>(e - p0 < 32 ? e - p0 : 32), B, K, colc, acc);
    }
    if (warp > 0) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) part[warp - 1][lane * VEC + i] = acc[i];
    }
    __syncthreads();
    if (warp == 0) {
      for (int w = 0; w < kWarps - 1; ++w) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = uadd(acc[i], part[w][lane * VEC + i]);
      }
      if (active) store_c<U, VEC>(C + r0 * K + col, acc);
    }
    return;
  }
  // a schedule not made by csr_blocks would overrun the row pointers' tile
  // or the int offsets relative to the block's first entry
  if (nr > kMaxRows || e - s > (1LL << 30)) __trap();
  for (int i = threadIdx.x; i <= nr; i += kThreads) {
    rp[i] = static_cast<int>(static_cast<long long>(__ldg(ptr + r0 + i)) - s);
  }
  __syncthreads();
  const I* __restrict__ bind = ind + s;
  const T* __restrict__ bval = val + s;
  for (int r = warp; r < nr; r += kWarps) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = uzero(U());
    const int q1 = rp[r + 1];
    for (int q0 = rp[r]; q0 < q1; q0 += 32) {
      const int q = q0 + lane;
      I c = 0;
      U v = uzero(U());
      if (q < q1) {
        c = __ldcs(bind + q);
        v = value(bval + q);
      }
      gather_chunk<U, I, VEC>(c, v, q1 - q0 < 32 ? q1 - q0 : 32, B, K, colc, acc);
    }
    if (active) store_c<U, VEC>(C + (r0 + r) * K + col, acc);
  }
}

template <typename T, typename P, typename I, int VEC>
int launch(const void* ptr, const void* ind, const void* val, const void* B, void* C, const void* blocks,
           long long nblk, long long K, void* stream) {
  using U = typename Sum<T>::type;
  const long long tiles = (K + 32 * VEC - 1) / (32 * VEC);
  const dim3 grid(static_cast<unsigned>(nblk), static_cast<unsigned>(tiles));
  spmm_csr_kernel<T, P, I, VEC><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const P*>(ptr), static_cast<const I*>(ind), static_cast<const T*>(val),
      static_cast<const U*>(B), static_cast<U*>(C), static_cast<const long long*>(blocks), K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int by_index(const void* ptr, const void* ind, const void* val, const void* B, void* C, const void* blocks,
             long long nblk, long long K, int ptr64, int ind64, void* stream) {
  if (ptr64) {
    return ind64 ? launch<T, long long, long long, VEC>(ptr, ind, val, B, C, blocks, nblk, K, stream)
                 : launch<T, long long, int, VEC>(ptr, ind, val, B, C, blocks, nblk, K, stream);
  }
  return ind64 ? launch<T, int, long long, VEC>(ptr, ind, val, B, C, blocks, nblk, K, stream)
               : launch<T, int, int, VEC>(ptr, ind, val, B, C, blocks, nblk, K, stream);
}

template <typename T>
int dispatch(const void* ptr, const void* ind, const void* val, const void* B, void* C, const void* blocks,
             long long nblk, long long K, int ptr64, int ind64, void* stream) {
  if (nblk <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  if constexpr (std::is_same<typename Sum<T>::type, float>::value) {
    // two floats a lane where every row segment starts 8-byte aligned: K
    // even and B and C 8-byte aligned (a tensor from PyTorch's allocator
    // is; a view at an offset may not be)
    const bool pair = K % 2 == 0 && ((reinterpret_cast<uintptr_t>(B) | reinterpret_cast<uintptr_t>(C)) & 7u) == 0;
    if (pair) return by_index<T, 2>(ptr, ind, val, B, C, blocks, nblk, K, ptr64, ind64, stream);
  }
  return by_index<T, 1>(ptr, ind, val, B, C, blocks, nblk, K, ptr64, ind64, stream);
}

}  // namespace

extern "C" {

// ptr (m + 1) and ind (nnz) int32 or int64 (ptr64, ind64), val (nnz) of
// the instance's value type, B (n, K) and C (m, K) row-major of its sum
// type, C written; blocks: the schedule, (nblk + 1) x 2 int64 (first row,
// first entry) pairs, the last (m, ptr[m]); K <= 65535 * 32
int spmm_csr_f32(const void* ptr, const void* ind, const void* val, const void* B, void* C, const void* blocks,
                 int64_t nblk, int64_t K, int ptr64, int ind64, void* stream) {
  return dispatch<float>(ptr, ind, val, B, C, blocks, nblk, K, ptr64, ind64, stream);
}

int spmm_csr_f64(const void* ptr, const void* ind, const void* val, const void* B, void* C, const void* blocks,
                 int64_t nblk, int64_t K, int ptr64, int ind64, void* stream) {
  return dispatch<double>(ptr, ind, val, B, C, blocks, nblk, K, ptr64, ind64, stream);
}

int spmm_csr_c64(const void* ptr, const void* ind, const void* val, const void* B, void* C, const void* blocks,
                 int64_t nblk, int64_t K, int ptr64, int ind64, void* stream) {
  return dispatch<float2>(ptr, ind, val, B, C, blocks, nblk, K, ptr64, ind64, stream);
}

int spmm_csr_c128(const void* ptr, const void* ind, const void* val, const void* B, void* C, const void* blocks,
                  int64_t nblk, int64_t K, int ptr64, int ind64, void* stream) {
  return dispatch<double2>(ptr, ind, val, B, C, blocks, nblk, K, ptr64, ind64, stream);
}

int spmm_csr_bf16(const void* ptr, const void* ind, const void* val, const void* B, void* C, const void* blocks,
                  int64_t nblk, int64_t K, int ptr64, int ind64, void* stream) {
  return dispatch<__nv_bfloat16>(ptr, ind, val, B, C, blocks, nblk, K, ptr64, ind64, stream);
}

}  // extern "C"
