// Band SpMM for NVIDIA Hopper (sm_90a): the two mm kernels of the `bandtm`
// execution form, a row-aligned (m, W) band times a dense row-major RHS.
//
// 1. spmm_band (mm KID 4), over the band itself (ExecForm.bwd_val,
//    v[i, j] = A[i, i + lo + j]):
//
//      C[i, :] = sum_{j < W} v[i, j] * B[start + i + j - padL, :]     (0 <= i < m)
//
//    Replaces aoclsparse_tpu/kernels/pallas/spmv.py:173 pallas_spmm_band_t
//    (and its wrapper spmm_bandtm, :220).
//
// 2. spmm_band_mxu (mm KID 5), over the block-window form of the same band
//    (ExecForm.band_mxu_dt, dt[k, c, s] = v[128k + s, c - s] for
//    0 <= c - s < W, W <= 129, else 0):
//
//      C[128k + s, :] = sum_{c < 256} dt[k, c, s] * B[start + 128k + c - padL, :]
//
//    which is the sum over the parallelogram 0 <= c - s < W; the caller
//    passes the form's W (W = 256 where it has none, which still skips the
//    zero lower triangle c < s).
//
//    Replaces aoclsparse_tpu/kernels/pallas/spmv.py:306 pallas_spmm_band_mxu
//    (and its wrapper spmm_bandmxu, :253).
//
// B rows outside [0, n) and columns past K contribute 0: the padL left
// padding and the ragged edges are index arithmetic here, so no padded copy
// of B is ever made. The peel spill is added by the wrapper after the
// launch (aoclsparse_tpu_torch/kernels/spmm_band.py). The TPU machinery of
// the Pallas kernels (eight pltpu.roll pre-rotated window copies, the lane
// padding of K and W to 128, VMEM-driven tile sizes) has no counterpart.
//
// What bounds them, at the bench operand (m = 262144, W = 128, K = 64, f32):
//   spmm_band: 134.2 MB of band + 67.1 MB of B + 67.1 MB of C = 268 MB at
//   3350 GB/s = 0.080 ms; 2.15 G FMA at 33.5 T FMA/s (67 TFLOP/s f32) =
//   0.064 ms. Bytes and FMAs are close, so the design reads B from device
//   memory about (TM + W - 1) / TM times, not W times, and keeps the FMA
//   loop fed from registers and shared memory.
//   spmm_band_mxu: what the function needs is the windows' parallelogram
//   (134.2 MB f32, 67.1 MB bf16) + 67.1 MB of B + 67.1 MB of C: 0.080 ms
//   f32, 0.060 ms bf16 (the stored windows, zero triangles and all: 0.120 /
//   0.080 ms), and 2.15 G FMA = 0.064 ms on the f32 CUDA cores. The TPU
//   kernel computed the whole 256-deep window on its matrix unit; this one
//   reads and multiplies only the window rows that meet a warp's rows'
//   bands. The JAX package pins the f32 product to HIGHEST precision
//   (spmv.py:289), so the f32 instance is exact f32 FMA, never TF32; the
//   bf16 instance rounds the B window to bf16 before the product
//   (spmv.py:292) and accumulates in f32, which is what a bf16 tensor-core
//   product computes.
//
// Design, spmm_band: a CTA of 256 threads owns a tile of kTM = 64 rows and
// kKC = 64 RHS columns. It stages the tile's band rows (contiguous in v)
// and the B rows [start + i0 - padL, + kTM + W - 1) of its column chunk in
// dynamic shared memory once. Thread (ty, tx) owns rows 4ty..4ty+3 and
// columns tx + 16q, q < 4: a register window of four B rows slides down by
// one row per j, so each j costs one new B row (4 values) and four band
// values from shared memory for 16 FMAs. Sums run over j in increasing
// order in the operand dtype. The B window's row stride kKCS = kKC + 4
// keeps the two row groups of a warp on distinct banks.
//
// Design, spmm_band_mxu: a CTA of 8 warps owns one 128-row block and
// kMxuKC = 64 columns; warp w owns rows s0 = 32 (w / 2) .. s0 + 31 and 32
// columns. The CTA walks window rows [0, min(256, 127 + W)) in slices of
// kCS = 32 through a 3-stage cp.async ring: a slice's dt vectors (16
// bytes: 4 f32 / 8 bf16 rows s of one window row c) are fetched only where
// they meet the parallelogram (the rest land as zeros, which they are),
// and its B rows only inside [0, n). A warp computes only the window rows
// c in [s0, min(256, s0 + 31 + W)) that meet its rows' bands: 159 of 256
// at W = 128.
//   f32 (CUDA cores): lane (lane / 8, lane % 8) owns 8 rows x 4 columns,
//   fed per window row by two 16-byte loads of dt and one of B (32 FMAs),
//   summed in increasing c.
//   bf16 (tensor cores): the landed B slice is rounded to bf16 (nearest
//   even) into one shared slice; the warp's tile is 2 x 2 wmma products of
//   16 x 16 x 16 (mma.sync m16n8k16, bf16 in, f32 accumulation), the dt
//   slice read as a column-major A; each 16-row half of the warp takes
//   only the 16-deep steps that meet its band.
// So a B value that only the windows' stored zeros outside a warp's walk
// would meet is never read: where it is Inf or NaN the kernel gives the
// band product's finite value and the full-window product NaN (0 * Inf).
//
// Instances (plain C entry points, bound with ctypes):
//   spmm_band_f32      : v f32, B f32, C f32 (f32 accumulation)
//   spmm_band_f64      : v f64, B f64, C f64
//   spmm_band_mxu_f32  : dt f32, B f32, C f32
//   spmm_band_mxu_bf16 : dt bf16, B f32 rounded to bf16, C f32
// Each launches on the given stream, does not synchronise, allocates
// nothing, and returns the CUDA error of the attribute call or the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 64;        // spmm_band: rows per CTA (16 groups of 4)
constexpr int kKC = 64;        // RHS columns per CTA (16 lanes x 4)
constexpr int kKCS = kKC + 4;  // shared row stride of a staged B row
constexpr int kMB = 128;       // spmm_band_mxu: rows per block
constexpr int kWB = 256;       // window rows per block
constexpr int kCS = 32;        // window rows staged per slice
constexpr int kMxuKC = 64;     // spmm_band_mxu: RHS columns per CTA
constexpr int kMxuStages = 3;  // its cp.async ring

__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
spmm_band_kernel(const T* __restrict__ v, const T* __restrict__ B, T* __restrict__ C, int64_t m,
                 int64_t n, int64_t K, int W, int64_t start, int64_t padL) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  T* bs = reinterpret_cast<T*>(band_smem);  // (kTM + W - 1) x kKCS window of B
  T* vs = bs + (kTM + W - 1) * kKCS;        // kTM x (W + 1) band tile
  const int WS = W + 1;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTM;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * kKC;
  const int tid = threadIdx.x;

  const int nrows = static_cast<int>(m - i0 < kTM ? m - i0 : kTM);
  const T* vtile = v + i0 * W;  // rows i0.. of v are contiguous
  for (int e = tid; e < kTM * W; e += kThreads) {
    const int r = e / W, j = e - r * W;
    vs[r * WS + j] = r < nrows ? vtile[e] : static_cast<T>(0);
  }
  const int64_t brow0 = start + i0 - padL;
  const int span = kTM + W - 1;
  for (int e = tid; e < span * kKC; e += kThreads) {
    const int t = e / kKC, c = e - t * kKC;
    const int64_t br = brow0 + t, bc = k0 + c;
    bs[t * kKCS + c] = (br >= 0 && br < n && bc < K) ? B[br * K + bc] : static_cast<T>(0);
  }
  __syncthreads();

  const int ty = tid / 16, tx = tid % 16;
  const int r0 = ty * 4;
  T acc[4][4];
  T win[4][4];  // win[a][q] = B window row r0 + a + j, column tx + 16q
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[a][q] = static_cast<T>(0);
      win[a][q] = a == 0 ? static_cast<T>(0) : bs[(r0 + a - 1) * kKCS + tx + 16 * q];
    }
  for (int j = 0; j < W; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      win[0][q] = win[1][q];
      win[1][q] = win[2][q];
      win[2][q] = win[3][q];
      win[3][q] = bs[(r0 + 3 + j) * kKCS + tx + 16 * q];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const T va = vs[(r0 + a) * WS + j];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][q] = mul_add(va, win[a][q], acc[a][q]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t i = i0 + r0 + a;
    if (i >= m) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t c = k0 + tx + 16 * q;
      if (c < K) C[i * K + c] = acc[a][q];
    }
  }
}

// ---- spmm_band_mxu ----------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes, of which the first `bytes` come from src and the rest are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory layout of one ring stage: the slice's window values
// ds[cc][s] (row stride kDS) and its B rows bs[cc][col] (f32, stride kMxuKC).
template <typename DT>
struct MxuLayout {
  static constexpr int kDS = sizeof(DT) == 4 ? kMB : kMB + 8;  // bf16: +16 B against bank conflicts
  static constexpr int kDsBytes = kCS * kDS * static_cast<int>(sizeof(DT));
  static constexpr int kStage = kDsBytes + kCS * kMxuKC * 4;
  static constexpr int kBB = kMxuKC + 8;  // bf16 B slice row stride
  static constexpr int kSmem = kMxuStages * kStage + (sizeof(DT) == 4 ? 0 : kCS * kBB * 2);
};

// cp.async of window-row slice q into ring stage `st`: the dt vectors that
// meet the parallelogram 0 <= c - s < W (others land as zeros) and the B
// rows start + 128k + c - padL (zeros outside [0, n) and past column K)
template <typename DT>
__device__ __forceinline__ void mxu_stage(unsigned char* st, const DT* __restrict__ dk,
                                          const float* __restrict__ B, int q, int cend, int W, int64_t brow0,
                                          int64_t n, int64_t K, int64_t k0, bool bvec) {
  using L = MxuLayout<DT>;
  constexpr int V = 16 / sizeof(DT);  // window values a vector
  constexpr int NV = kMB / V;         // vectors a window row
  DT* ds = reinterpret_cast<DT*>(st);
  float* bs = reinterpret_cast<float*>(st + L::kDsBytes);
  const int c0 = q * kCS;
#pragma unroll
  for (int j = 0; j < kCS * NV / kThreads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int cc = e / NV, s = (e - cc * NV) * V, c = c0 + cc;
    const bool meet = c < cend && static_cast<unsigned>(c - s) < static_cast<unsigned>(W + V - 1);
    cp_async16(ds + cc * L::kDS + s, meet ? dk + c * kMB + s : dk, meet ? 16 : 0);
  }
  if (bvec) {
#pragma unroll
    for (int j = 0; j < kCS * kMxuKC / 4 / kThreads; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int cc = e / (kMxuKC / 4), col = (e - cc * (kMxuKC / 4)) * 4;
      const int64_t br = brow0 + c0 + cc;
      const bool in = c0 + cc < cend && br >= 0 && br < n && k0 + col < K;
      cp_async16(bs + cc * kMxuKC + col, in ? B + br * K + k0 + col : B, in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < kCS * kMxuKC / kThreads; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int cc = e / kMxuKC, col = e - cc * kMxuKC;
      const int64_t br = brow0 + c0 + cc;
      const bool in = c0 + cc < cend && br >= 0 && br < n && k0 + col < K;
      cp_async4(bs + cc * kMxuKC + col, in ? B + br * K + k0 + col : B, in ? 4 : 0);
    }
  }
}

// f32: a CTA of 8 warps owns one 128-row block and kMxuKC = 64 columns;
// warp w owns rows s0 = 32 (w / 2) .. s0 + 31 and columns 32 (w % 2) ..
// + 31, lane (lr, lc) = (lane / 8, lane % 8) rows s0 + 8 lr + a (a < 8) and
// columns 4 lc + b (b < 4): per window row two 16-byte loads of dt (the
// eight rows), one of B (the four columns), 32 exact f32 FMAs. A warp walks
// only the window rows c in [s0, min(256, s0 + 31 + W)) that meet its
// rows' bands, in increasing c.
__global__ void __launch_bounds__(kThreads)
spmm_band_mxu_f32_kernel(const float* __restrict__ dt, const float* __restrict__ B, float* __restrict__ C,
                         int64_t m, int64_t n, int64_t K, int64_t start, int64_t padL, int W, int bvec) {
  using L = MxuLayout<float>;
  extern __shared__ __align__(128) unsigned char mxu_smem[];
  const int64_t kb = blockIdx.x;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * kMxuKC;
  const float* dk = dt + kb * kWB * kMB;
  const int64_t brow0 = start + kb * kMB - padL;
  const int cend = min(kWB, kMB - 1 + W);  // the block's last band window row + 1
  const int nslice = (cend + kCS - 1) / kCS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s0 = (warp >> 1) * 32, cb = (warp & 1) * 32;
  const int sr = s0 + 8 * (lane >> 3), col = cb + 4 * (lane & 7);
  const int wend = min(kWB, s0 + 31 + W);  // the warp's window rows: [s0, wend)

  float acc[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

#pragma unroll
  for (int q = 0; q < kMxuStages - 1; ++q) {
    if (q < nslice) mxu_stage<float>(mxu_smem + q * L::kStage, dk, B, q, cend, W, brow0, n, K, k0, bvec);
    cp_async_commit();
  }
  for (int q = 0; q < nslice; ++q) {
    cp_async_wait<kMxuStages - 2>();
    __syncthreads();
    const int qn = q + kMxuStages - 1;
    if (qn < nslice)
      mxu_stage<float>(mxu_smem + (qn % kMxuStages) * L::kStage, dk, B, qn, cend, W, brow0, n, K, k0, bvec);
    cp_async_commit();
    const unsigned char* st = mxu_smem + (q % kMxuStages) * L::kStage;
    const float* ds = reinterpret_cast<const float*>(st);
    const float* bs = reinterpret_cast<const float*>(st + L::kDsBytes);
    const int c0 = q * kCS;
    const int lo = max(c0, s0) - c0, hi = min(c0 + kCS, wend) - c0;
#pragma unroll 4
    for (int cc = lo; cc < hi; ++cc) {
      const float4 d0 = *reinterpret_cast<const float4*>(ds + cc * L::kDS + sr);
      const float4 d1 = *reinterpret_cast<const float4*>(ds + cc * L::kDS + sr + 4);
      const float4 bv = *reinterpret_cast<const float4*>(bs + cc * kMxuKC + col);
      const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[a][j] = fmaf(d[a], b[j], acc[a][j]);
    }
  }
  cp_async_wait<0>();
  const int64_t c = k0 + col;
  const bool cvec = (K & 3) == 0 && c + 3 < K;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int64_t i = kb * kMB + sr + a;
    if (i >= m) break;
    if (cvec) {
      *reinterpret_cast<float4*>(C + i * K + c) = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < K) C[i * K + c + j] = acc[a][j];
    }
  }
}

// bf16: the same CTA, slices and ring; after a slice lands its B rows are
// rounded to bf16 (nearest even) into one shared slice, and each warp runs
// its 32 x 32 tile as 2 x 2 bf16 tensor-core products of 16 x 16 x 16
// (wmma, mma.sync m16n8k16, f32 accumulation): the A operand is the dt
// slice read as column-major (dt[k, c, s] is A[s, c]), B row-major. A
// 16-row half i of the warp's rows takes only the 16-deep steps of window
// rows that meet its band: c in [s0 + 16i, min(256, s0 + 16i + 15 + W)).
__global__ void __launch_bounds__(kThreads)
spmm_band_mxu_bf16_kernel(const __nv_bfloat16* __restrict__ dt, const float* __restrict__ B,
                          float* __restrict__ C, int64_t m, int64_t n, int64_t K, int64_t start, int64_t padL,
                          int W, int bvec) {
  using namespace nvcuda;
  using L = MxuLayout<__nv_bfloat16>;
  extern __shared__ __align__(128) unsigned char mxu_smem[];
  __nv_bfloat16* bsb = reinterpret_cast<__nv_bfloat16*>(mxu_smem + kMxuStages * L::kStage);
  const int64_t kb = blockIdx.x;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * kMxuKC;
  const __nv_bfloat16* dk = dt + kb * kWB * kMB;
  const int64_t brow0 = start + kb * kMB - padL;
  const int cend = min(kWB, kMB - 1 + W);
  const int nslice = (cend + kCS - 1) / kCS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s0 = (warp >> 1) * 32, cb = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int q = 0; q < kMxuStages - 1; ++q) {
    if (q < nslice)
      mxu_stage<__nv_bfloat16>(mxu_smem + q * L::kStage, dk, B, q, cend, W, brow0, n, K, k0, bvec);
    cp_async_commit();
  }
  for (int q = 0; q < nslice; ++q) {
    cp_async_wait<kMxuStages - 2>();
    __syncthreads();  // slice q landed; every warp is done with slice q - 1
    const unsigned char* st = mxu_smem + (q % kMxuStages) * L::kStage;
    const float* bs = reinterpret_cast<const float*>(st + L::kDsBytes);
#pragma unroll
    for (int j = 0; j < kCS * kMxuKC / 4 / kThreads; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int cc = e / (kMxuKC / 4), cl = (e - cc * (kMxuKC / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(bs + cc * kMxuKC + cl);
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(bsb + cc * L::kBB + cl);
      o[0] = __floats2bfloat162_rn(v.x, v.y);
      o[1] = __floats2bfloat162_rn(v.z, v.w);
    }
    __syncthreads();
    const int qn = q + kMxuStages - 1;
    if (qn < nslice)
      mxu_stage<__nv_bfloat16>(mxu_smem + (qn % kMxuStages) * L::kStage, dk, B, qn, cend, W, brow0, n, K, k0,
                               bvec);
    cp_async_commit();
    const __nv_bfloat16* ds = reinterpret_cast<const __nv_bfloat16*>(st);
#pragma unroll
    for (int t = 0; t < kCS / 16; ++t) {
      const int c = q * kCS + 16 * t;  // the step's first window row
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
      bool loaded = false;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = s0 + 16 * i;
        if (c + 15 < r || c >= min(kWB, r + 15 + W)) continue;  // warp-uniform
        if (!loaded) {
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], bsb + 16 * t * L::kBB + cb + 16 * j, L::kBB);
          loaded = true;
        }
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, ds + 16 * t * L::kDS + r, L::kDS);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: each warp parks its 32 x 32 tile there
  constexpr int kOS = 36;
  float* os = reinterpret_cast<float*>(mxu_smem) + warp * 32 * kOS;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::store_matrix_sync(os + 16 * i * kOS + 16 * j, acc[i][j], kOS, wmma::mem_row_major);
  __syncwarp();
  const int64_t c = k0 + cb + 4 * (lane & 7);
  const bool cvec = (K & 3) == 0 && c + 3 < K;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int r = 4 * it + (lane >> 3);
    const int64_t i = kb * kMB + s0 + r;
    if (i >= m) break;
    const float4 v = *reinterpret_cast<const float4*>(os + r * kOS + 4 * (lane & 7));
    if (cvec) {
      *reinterpret_cast<float4*>(C + i * K + c) = v;
    } else {
      const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < K) C[i * K + c + j] = w[j];
    }
  }
}

template <typename T>
int launch_band(const void* v, const void* B, void* C, int64_t m, int64_t n, int64_t K, int64_t W,
                int64_t start, int64_t padL, void* stream) {
  if (m <= 0 || K <= 0) return 0;
  const size_t smem = static_cast<size_t>((kTM + W - 1) * kKCS + kTM * (W + 1)) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(spmm_band_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((m + kTM - 1) / kTM),
                  static_cast<unsigned>((K + kKC - 1) / kKC));
  spmm_band_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), static_cast<const T*>(B), static_cast<T*>(C), m, n, K,
      static_cast<int>(W), start, padL);
  return static_cast<int>(cudaGetLastError());
}

template <typename DT>
int launch_mxu(void (*kern)(const DT*, const float*, float*, int64_t, int64_t, int64_t, int64_t, int64_t, int, int),
               const void* dt, const void* B, void* C, int64_t nblk, int64_t m, int64_t n, int64_t K,
               int64_t start, int64_t padL, int64_t W, void* stream) {
  if (m <= 0 || K <= 0 || nblk <= 0) return 0;
  if (W < 1 || W > kWB) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = MxuLayout<DT>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bvec = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(B) % 16 == 0);
  const dim3 grid(static_cast<unsigned>(nblk), static_cast<unsigned>((K + kMxuKC - 1) / kMxuKC));
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const DT*>(dt), static_cast<const float*>(B), static_cast<float*>(C), m, n, K, start, padL,
      static_cast<int>(W), bvec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int spmm_band_f32(const void* v, const void* B, void* C, int64_t m, int64_t n, int64_t K,
                  int64_t W, int64_t start, int64_t padL, void* stream) {
  return launch_band<float>(v, B, C, m, n, K, W, start, padL, stream);
}

int spmm_band_f64(const void* v, const void* B, void* C, int64_t m, int64_t n, int64_t K,
                  int64_t W, int64_t start, int64_t padL, void* stream) {
  return launch_band<double>(v, B, C, m, n, K, W, start, padL, stream);
}

int spmm_band_mxu_f32(const void* dt, const void* B, void* C, int64_t nblk, int64_t m, int64_t n,
                      int64_t K, int64_t start, int64_t padL, int64_t W, void* stream) {
  return launch_mxu<float>(spmm_band_mxu_f32_kernel, dt, B, C, nblk, m, n, K, start, padL, W, stream);
}

int spmm_band_mxu_bf16(const void* dt, const void* B, void* C, int64_t nblk, int64_t m, int64_t n,
                       int64_t K, int64_t start, int64_t padL, int64_t W, void* stream) {
  return launch_mxu<__nv_bfloat16>(spmm_band_mxu_bf16_kernel, dt, B, C, nblk, m, n, K, start, padL, W, stream);
}

}  // extern "C"
