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
// band (71 MB as bf16, 285 MB as f64) against 2 MB of x and y, at 2 flops
// per band value, far below the card's flop:byte balance. So device-memory
// bandwidth bounds the kernel, and the design has one aim: read every band
// value once, in full 16-byte loads, with enough bytes in flight.
//
// Design: one warp per 8-row group, kWarps groups per block. The planner
// rounds W up to a multiple of 8 (the wrapper requires it), so a group is
// 8 rows of W / V 16-byte vectors (V = 4 f32, 8 bf16, 2 f64), every row
// start 16-byte aligned. Lane l serves row r = l / 4 and reads that row's
// vectors j = l % 4, j + 4, ...: each step the warp loads 8 rows x 64
// contiguous bytes (512 bytes), and a lane keeps one partial sum, its
// row's, so no sum is chosen by a run-time index. A lane issues its loads
// in as few batches of at most kUnroll = 5 as it can, split evenly (at
// W = 136, lane 0: one batch of 5 vectors for bf16, 5 + 4 for f32,
// 5 + 5 + 5 + 2 for f64), so that no batch but the last of f64 is a nearly
// empty round trip to memory; the group's spill range is read before them
// and arrives with the first batch. The x window
// is the same for all 8 rows (win[b, r, t] meets x[8 (b + base8) + t -
// padL] whatever r is), so a lane reads the V x values of its vector from
// the read-only path, where neighbouring groups' windows hit in L1 and L2:
// as 16-byte loads when the group's window lies inside [0, n) and its first
// x value is 16-byte aligned, else one checked value at a time. The four
// lanes of a row then add their sums with two shuffles (xor 1, xor 2).
// The group's spill entries are split over the 32 lanes, each adding its
// products into one of 8 per-row sums by an unrolled select (the peel
// spills the clipped windows at the matrix's edges, so a few groups hold
// ~100 entries each); a butterfly gives every lane the 8 spill sums and
// each lane adds its row's. Lanes 0-7 then write y[8b + lane], fetched by
// one shuffle from the row's first lane (one 32-byte store in f32).
//
// Sums: float32 (float64 for the f64 instance). Row r: each of its four
// lanes sums its vectors in increasing t, a vector's V values in order, by
// fused multiply-adds; the four lane sums meet as (s0 + s1) + (s2 + s3);
// then the row's spill sum is added (each lane's entries in order, the 32
// lanes' sums in a butterfly xor 16, 8, 4, 2, 1).
//
// Instances (plain C entry points, bound with ctypes):
//   spmv_bwd_f32  : band f32,  x f32, accumulate f32
//   spmv_bwd_bf16 : band bf16, x f32, accumulate f32 (exact widening)
//   spmv_bwd_f64  : band f64,  x f64, accumulate f64
// Each launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // groups (warps) per block
constexpr int kG = 8;       // rows per group
constexpr int kLanes = 4;   // lanes per row
constexpr int kUnroll = 5;  // most loads a lane issues together

// the V values of one 16-byte band load, widened to the sum's type
__device__ __forceinline__ void unpack(const uint4 r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}

// a bf16 is the high half of the float32 it widens to; value 2h sits in the
// low half of word h
__device__ __forceinline__ void unpack(const uint4 r, float (&v)[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    v[2 * h] = __uint_as_float(w[h] << 16);
    v[2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4 r, double (&v)[2]) {
  v[0] = __hiloint2double(static_cast<int>(r.y), static_cast<int>(r.x));
  v[1] = __hiloint2double(static_cast<int>(r.w), static_cast<int>(r.z));
}

__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }

// the V x values of one vector, x index k0 + v: 16-byte loads when `vec`
// (inside [0, n), aligned), else one checked value at a time
template <typename T, int V>
__device__ __forceinline__ void load_x(const T* __restrict__ x, int64_t k0, int64_t n, bool vec, T (&xv)[V]) {
  constexpr int P = 16 / sizeof(T);  // values a 16-byte load
  if (vec) {
#pragma unroll
    for (int h = 0; h < V / P; ++h) {
      T part[P];
      unpack(__ldg(reinterpret_cast<const uint4*>(x + k0) + h), part);
#pragma unroll
      for (int v = 0; v < P; ++v) xv[h * P + v] = part[v];
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int64_t k = k0 + v;
      xv[v] = (k >= 0 && k < n) ? __ldg(x + k) : static_cast<T>(0);
    }
  }
}

template <typename VT, typename T>
__global__ void __launch_bounds__(kWarps * 32)
spmv_bwd_kernel(const VT* __restrict__ win, const T* __restrict__ x, T* __restrict__ y,
                const T* __restrict__ sp_val, const int64_t* __restrict__ sp_ind,
                const int64_t* __restrict__ sp_rows, const int64_t* __restrict__ sp_gptr,
                int64_t nblk, int64_t m, int64_t n, int W, int64_t base8, int64_t padL) {
  constexpr int V = 16 / sizeof(VT);  // band values a vector
  const int lane = threadIdx.x & 31;
  const int row = lane / kLanes, j = lane % kLanes;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= nblk) return;  // uniform across the warp
  const int nvec = W / V;  // vectors a row
  const VT* wr = win + (b * kG + row) * static_cast<int64_t>(W);
  const int64_t x0 = kG * (b + base8) - padL;  // x index of window position 0
  const bool vec = x0 >= 0 && x0 + W <= n && (reinterpret_cast<uintptr_t>(x + x0) & 15) == 0;

  // the group's spill range, asked for first so that it arrives with the band
  const int64_t e0 = sp_gptr != nullptr ? sp_gptr[b] : 0, e1 = sp_gptr != nullptr ? sp_gptr[b + 1] : 0;
  const int nv = (nvec - j + kLanes - 1) / kLanes;  // vectors of this lane
  const int nb = (nv + kUnroll - 1) / kUnroll;       // batches
  const int per = nb ? (nv + nb - 1) / nb : 0;       // vectors a batch, <= kUnroll

  T acc = static_cast<T>(0);
  for (int k = 0; k < nb; ++k) {
    const int i0 = j + kLanes * k * per;
    const int cnt = min(per, nv - k * per);
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = i0 + kLanes * u;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (u < cnt) raw[u] = __ldcs(reinterpret_cast<const uint4*>(wr + q * V));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = i0 + kLanes * u;
      if (u < cnt) {
        T val[V], xv[V];
        unpack(raw[u], val);
        load_x<T, V>(x, x0 + q * V, n, vec, xv);
#pragma unroll
        for (int v = 0; v < V; ++v) acc = mul_add(val[v], xv[v], acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (e1 > e0) {  // uniform across the warp
    T sp[kG];
#pragma unroll
    for (int r = 0; r < kG; ++r) sp[r] = static_cast<T>(0);
    for (int64_t e = e0 + lane; e < e1; e += 32) {
      const T c = sp_val[e] * __ldg(x + sp_ind[e]);
      const int64_t r = sp_rows[e] - kG * b;
#pragma unroll
      for (int rr = 0; rr < kG; ++rr) sp[rr] += (r == rr) ? c : static_cast<T>(0);
    }
#pragma unroll
    for (int r = 0; r < kG; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sp[r] += __shfl_xor_sync(0xffffffffu, sp[r], off);
    }
    T mine = sp[0];
#pragma unroll
    for (int r = 1; r < kG; ++r) mine = (row == r) ? sp[r] : mine;
    acc += mine;
  }
  const T out = __shfl_sync(0xffffffffu, acc, (lane % kG) * kLanes);
  const int64_t i = kG * b + lane;
  if (lane < kG && i < m) y[i] = out;
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
