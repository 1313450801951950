// Block-window band SpMV for NVIDIA Hopper (sm_90a), over the
// (nblk, 256, 128) block windows of a band (ExecForm.band_mxu_dt,
// kernels/spmm_band.py `band_mxu_blocks`: dt[k, c, s] = A-band entry c - s
// of row 128k + s for 0 <= c - s < W, W <= 129, else 0):
//
//     y[128k + s] = sum_{0 <= c - s < W, c < 256} dt[k, c, s] * x[start + 128k + c - padL]   (128k + s < m)
//
// The sum is the one over all 256 window rows, since the windows hold zeros
// outside the parallelogram 0 <= c - s < W; a caller with no band width at
// hand passes W = 256, which still skips the zero lower triangle (c < s).
// x indices outside [0, n) contribute 0, so no padded copy of x is made.
// The planner's peel spill is added by the wrapper after the launch.
//
// Replaces aoclsparse_tpu/kernels/pallas/spmv.py:1019 pallas_spmv_band_mxu,
// which runs each 128-row block as a (1, 256) x (256, 128) product on the
// TPU's matrix unit, zero triangles and all. A matrix-vector product has one
// column: Hopper's tensor cores would idle on it, so this is a CUDA-core
// kernel, and it is its own kernel, not the K = 1 case of the block-window
// SpMM (csrc/spmm_band.cu spmm_band_mxu, whose tile is laid out for 64
// columns).
//
// What bounds it: device-memory bytes, at 2 flops a value. The windows
// store 256 x 128 values a block; the product needs only the parallelogram,
// W x 128 a block (half the windows at W = 128). At the bench operand
// (m = 262144, W = 128) that is 134 MB of f32 (67 MB as bf16) against 2 MB
// of x and y. On an NVIDIA H100 80GB HBM3 (700 W; chip_smoke.py phase 6
// reads the same windows as W = 1, 64, 128 and 256) the extra band between
// W = 64 and W = 128 streams at the card's read rate, while a read of next
// to nothing (W = 1) still takes ~0.011 ms: a floor of launch and memory
// latency that the kernel pays on top of its bytes.
//
// Design: a CTA of 256 threads owns kBlk = 2 consecutive 128-row blocks and
// stages their x window, 128 (kBlk + 1) values zero outside [0, n), in
// shared memory (the bf16 instance rounds it to bf16 there, as the JAX
// kernel's xq.astype(dt.dtype) does, spmv.py:1009). Each warp owns a run of
// 32 rows s0 <= s < s0 + 32 of one block and walks only the window rows
// c in [s0, min(256, s0 + 31 + W)) that meet its rows' bands: 159 of 256 at
// W = 128. A lane reads V = 16 / sizeof(value) consecutive s of one window
// row with one 16-byte load (4 f32 or 8 bf16), so 32 / V lanes cover the
// run's 32 rows and the warp's V lane groups read V window rows a step
// (512 bytes). A lane loads only where its V rows meet row c's band, so a
// sector no lane of a step needs is never fetched; at the parallelogram's
// edges a load may read a stored zero, which each value's own band test
// (0 <= c - s < W) then leaves out of its sum. Eight steps' loads are
// issued before their products, so each thread keeps 128 bytes in flight.
//
// Sums: float32. Lane group g (of V) sums, for each of its V rows, the
// window rows c = s0 + g, s0 + g + V, ... in increasing c with one fused
// multiply-add each; the V group sums of a row then meet in a butterfly of
// shuffles (xor 32 / V, then doubling), and the first lane group writes its
// rows' sums.
//
// Instances (plain C entry points, bound with ctypes):
//   spmv_band_mxu_f32  : dt f32,  x f32, y f32
//   spmv_band_mxu_bf16 : dt bf16, x f32 rounded to bf16, y f32 (f32 sums)
// Each launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMB = 128;  // rows a block
constexpr int kWB = 256;  // window rows a block
constexpr int kBlk = 2;   // blocks a CTA
constexpr int kThreads = kMB * kBlk;
constexpr int kRun = 32;     // rows a warp
constexpr int kUnroll = 8;   // steps whose loads are issued together

// the V values of one 16-byte load, widened to float
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

// x in the dt dtype: f32 stays, bf16 rounds to nearest even
__device__ __forceinline__ float round_x(float v, float) { return v; }
__device__ __forceinline__ float round_x(float v, __nv_bfloat16) { return __bfloat162float(__float2bfloat16(v)); }

template <typename DT>
__global__ void __launch_bounds__(kThreads)
spmv_mxu_kernel(const DT* __restrict__ dt, const float* __restrict__ x, float* __restrict__ y, int64_t nblk,
                int64_t m, int64_t n, int64_t start, int64_t padL, int W) {
  constexpr int V = 16 / sizeof(DT);  // rows a lane, lane groups a warp
  constexpr int L = kRun / V;         // lanes a window row
  __shared__ float xs[kMB * (kBlk + 1)];
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kBlk;
  const int64_t xbase = start + k0 * kMB - padL;  // x index held by xs[0]
  for (int e = threadIdx.x; e < kMB * (kBlk + 1); e += kThreads) {
    const int64_t k = xbase + e;
    xs[e] = (k >= 0 && k < n) ? round_x(x[k], DT()) : 0.0f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = warp / (kMB / kRun);                 // block of the CTA
  const int s0 = (warp % (kMB / kRun)) * kRun;       // the warp's first row
  const int g = lane / L;                            // lane group: window rows c = s0 + g (mod V)
  const int sl = s0 + (lane % L) * V;                // the lane's first row
  const int64_t kb = k0 + q;
  if (kb >= nblk || kb * kMB + s0 >= m) return;  // uniform across the warp
  const int cend = min(kWB, s0 + kRun - 1 + W);  // past the run's last band row
  const int steps = (cend - s0 + V - 1) / V;
  const DT* p = dt + kb * kWB * kMB + sl;
  const float* xw = xs + q * kMB;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  for (int i0 = 0; i0 < steps; i0 += kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = s0 + g + V * (i0 + u);
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      // some row sl + v of the lane has 0 <= c - (sl + v) < W
      if (c < cend && static_cast<unsigned>(c - sl) < static_cast<unsigned>(W + V - 1))
        raw[u] = __ldcs(reinterpret_cast<const uint4*>(p + c * kMB));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = s0 + g + V * (i0 + u);
      if (c < cend) {
        float val[V];
        unpack(raw[u], val);
        const float xv = xw[c];
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (static_cast<unsigned>(c - sl - v) < static_cast<unsigned>(W)) acc[v] = fmaf(val[v], xv, acc[v]);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int off = L; off < 32; off <<= 1) acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], off);
  }
  if (g != 0) return;
  const int64_t i = kb * kMB + sl;
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (i + v < m) y[i + v] = acc[v];
}

template <typename DT>
int launch(const void* dt, const void* x, void* y, int64_t nblk, int64_t m, int64_t n, int64_t start,
           int64_t padL, int64_t W, void* stream) {
  if (m <= 0 || nblk <= 0) return 0;
  const int64_t grid = (nblk + kBlk - 1) / kBlk;
  spmv_mxu_kernel<DT><<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const DT*>(dt), static_cast<const float*>(x), static_cast<float*>(y), nblk, m, n, start, padL,
      static_cast<int>(W));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int spmv_band_mxu_f32(const void* dt, const void* x, void* y, int64_t nblk, int64_t m, int64_t n, int64_t start,
                      int64_t padL, int64_t W, void* stream) {
  return launch<float>(dt, x, y, nblk, m, n, start, padL, W, stream);
}

int spmv_band_mxu_bf16(const void* dt, const void* x, void* y, int64_t nblk, int64_t m, int64_t n,
                       int64_t start, int64_t padL, int64_t W, void* stream) {
  return launch<__nv_bfloat16>(dt, x, y, nblk, m, n, start, padL, W, stream);
}

}  // extern "C"
