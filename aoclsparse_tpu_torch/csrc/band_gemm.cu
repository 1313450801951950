// Band x band SpGEMM numeric stage for NVIDIA Hopper (sm_90a), the kernel
// of the SpGEMM band engine (kernels/spgemm_band.py):
//
//     for each row group g and stream s with rho_lo < rho_hi:
//       C[g, :, G*s : G*s+WB] += A[g, :, rho_lo:rho_hi]
//                                @ B[g+d0+s, br_lo : br_lo+(rho_hi-rho_lo), :]
//
// over A (nblk, G, WA) and B (nblk, G, WB), the planner's G-row-group
// windows of the two operands, into C (nblk, G, WC). A block index g+d0+s
// outside [0, nblk) contributes nothing; every element of C is written
// exactly once, zeros included.
//
// Replaces aoclsparse_tpu/kernels/pallas/spgemm.py:38 pallas_band_gemm. Its
// TPU machinery has no counterpart: the zero-padded B copy that keeps every
// BlockSpec index in range (out-of-range blocks are skipped here) and the
// lane-dimension pad-and-add that places each stream's product (each thread
// owns its C elements in registers across the streams).
//
// What bounds it, at the cant stand-in's A.A (G = 128, WA = WB = 560,
// WC = 1072, 5 streams, nblk = 489): 39.3 GFLOP of band products counting
// the zeros, at 67 TFLOP/s of f32 FMA = 0.59 ms; its bytes (140 + 140 MB
// in, 268 MB out) take 0.16 ms at 3350 GB/s, so operations bound it. The
// f32 instance is exact f32 FMA on the CUDA cores, no TF32: the JAX
// package pins Precision.HIGHEST (spgemm.py:85-94), and the tensor cores
// take f32 only as TF32. The band's zero blocks are computed too; skipping
// them, and wgmma on a bf16 operand, are later work.
//
// Design (a simple first one): a CTA of 256 threads owns a 64 x 64 tile of
// one C_g and loops over the streams whose column span [G*s, G*s+WB) meets
// it. For each such stream it walks the slab rows rho_lo..rho_hi in steps of
// 16: it stages the 64 x 16 chunk of A_g (transposed) and the 16 x 64 chunk
// of B_{g+d0+s} in shared memory, zero-filling what lies outside the slab,
// the group or the stream's columns, and each thread adds the outer
// products into its 4 x 4 register block (rows ty + 16u, columns tx + 16v,
// so a warp reads one broadcast A address pair and 16 consecutive B
// columns). No atomics: a C element belongs to one thread of one CTA. The
// grid's x walks the column tiles of a group before the next group, so
// the CTAs that share A_g run together and find it in L2.
//
// Instances (plain C entry points, bound with ctypes):
//   band_gemm_f32 : A, B, C float32, f32 accumulation
//   band_gemm_f64 : A, B, C float64
// Each takes the streams as a host array of 3 * nstream int32 (rho_lo,
// rho_hi, br_lo), launches once on the given stream, does not synchronise,
// allocates nothing, and returns the CUDA error of the launch (0 on
// success).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxStreams = 6;  // the planner's cap (spgemm_band.py)
constexpr int kThreads = 256;
constexpr int kTM = 64;  // C rows per CTA
constexpr int kTN = 64;  // C columns per CTA
constexpr int kTK = 16;  // slab rows per staging step

struct Streams {
  int n;
  int lo[kMaxStreams];
  int hi[kMaxStreams];
  int br[kMaxStreams];
};

__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C, int nblk, int G,
                 int WA, int WB, int WC, int d0, int ncol_tiles, Streams st) {
  __shared__ T As[kTK][kTM + 1];  // A chunk, transposed: As[k][row]
  __shared__ T Bs[kTK][kTN];      // B chunk: Bs[k][column]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int g = blockIdx.x / ncol_tiles;
  const int c0 = (blockIdx.x - g * ncol_tiles) * kTN;
  const int r0 = blockIdx.y * kTM;
  const T* Ag = A + static_cast<size_t>(g) * G * WA;

  T acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = static_cast<T>(0);

  for (int s = 0; s < st.n; ++s) {
    const int lo = st.lo[s], hi = st.hi[s], br = st.br[s];
    const int gb = g + d0 + s;
    const int cs = G * s;  // the stream's first C column
    // block-uniform: every thread takes the same branch
    if (hi <= lo || gb < 0 || gb >= nblk || cs >= c0 + kTN || cs + WB <= c0) continue;
    const T* Bg = B + static_cast<size_t>(gb) * G * WB;
    for (int k0 = lo; k0 < hi; k0 += kTK) {
      for (int e = tid; e < kTM * kTK; e += kThreads) {
        const int i = e / kTK, k = e - i * kTK;
        const int r = r0 + i, kk = k0 + k;
        As[k][i] = (r < G && kk < hi) ? Ag[static_cast<size_t>(r) * WA + kk] : static_cast<T>(0);
      }
      for (int e = tid; e < kTK * kTN; e += kThreads) {
        const int k = e / kTN, j = e - k * kTN;
        const int kk = k0 + k, bc = c0 + j - cs;
        Bs[k][j] = (kk < hi && bc >= 0 && bc < WB) ? Bg[static_cast<size_t>(br + kk - lo) * WB + bc]
                                                   : static_cast<T>(0);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kTK; ++k) {
        T a[4], b[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          a[u] = As[k][ty + 16 * u];
          b[u] = Bs[k][tx + 16 * u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = mul_add(a[u], b[v], acc[u][v]);
      }
      __syncthreads();
    }
  }

  T* Cg = C + static_cast<size_t>(g) * G * WC;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = r0 + ty + 16 * u;
    if (r >= G) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int c = c0 + tx + 16 * v;
      if (c < WC) Cg[static_cast<size_t>(r) * WC + c] = acc[u][v];
    }
  }
}

template <typename T>
int launch(const void* A, const void* B, void* C, int64_t nblk, int64_t G, int64_t WA, int64_t WB,
           int64_t WC, int64_t d0, const int32_t* ranges, int64_t nstream, void* stream) {
  if (nblk <= 0 || G <= 0 || WC <= 0) return 0;
  if (nstream < 0 || nstream > kMaxStreams) return static_cast<int>(cudaErrorInvalidValue);
  Streams st{};
  st.n = static_cast<int>(nstream);
  for (int s = 0; s < st.n; ++s) {
    st.lo[s] = ranges[3 * s];
    st.hi[s] = ranges[3 * s + 1];
    st.br[s] = ranges[3 * s + 2];
  }
  const int64_t ncol = (WC + kTN - 1) / kTN;
  if (nblk * ncol > INT_MAX || G * WC > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nblk * ncol), static_cast<unsigned>((G + kTM - 1) / kTM));
  band_gemm_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<T*>(C), static_cast<int>(nblk),
      static_cast<int>(G), static_cast<int>(WA), static_cast<int>(WB), static_cast<int>(WC),
      static_cast<int>(d0), static_cast<int>(ncol), st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int band_gemm_f32(const void* A, const void* B, void* C, int64_t nblk, int64_t G, int64_t WA, int64_t WB,
                  int64_t WC, int64_t d0, const int32_t* ranges, int64_t nstream, void* stream) {
  return launch<float>(A, B, C, nblk, G, WA, WB, WC, d0, ranges, nstream, stream);
}

int band_gemm_f64(const void* A, const void* B, void* C, int64_t nblk, int64_t G, int64_t WA, int64_t WB,
                  int64_t WC, int64_t d0, const int32_t* ranges, int64_t nstream, void* stream) {
  return launch<double>(A, B, C, nblk, G, WA, WB, WC, d0, ranges, nstream, stream);
}

}  // extern "C"
