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
//   memory about (TM + W - 1) / TM times, not W times, keeps the FMA loop
//   fed from registers and 16-byte shared loads, and streams the band
//   while the FMAs run. A first design staged the whole band tile and B
//   window before any FMA (85 KB at W = 128, load, barrier, compute) and
//   fed 16 FMAs with 8 four-byte shared loads: 0.3118 ms (PERF.md §6).
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
// Design, spmm_band: a CTA of 128 threads owns a tile of kBandTM = 128
// rows and one 256-byte column chunk of B (64 f32 / 32 f64 columns). The
// band is streamed through a three-stage cp.async ring in chunks of JC
// band columns j (16 f32 / 8 f64), stored j-major (vs[j][r], row stride
// kBandTM + 8, so each copy's 8 rows x 4 j land on 32 distinct banks and a
// thread's 8 band values for one j are two (f64: four) 16-byte loads). The
// tile's B rows [start + i0 - padL, + kBandTM + W - 1) flow through a ring
// of kBandRing = 256 rows: a chunk brings only its JC new rows. Copies run
// two chunks ahead of the FMAs, and shared memory (90 KB, two CTAs an SM)
// no longer grows with W. Thread (g, l) owns rows 8g .. 8g + 7 and the two
// 16-byte column vectors l and l + 8 of the chunk: a register window of
// eight B rows slides down one row per j, so each j costs two 16-byte B
// loads and the eight band values for 8 x 8 (f64: 8 x 4) FMAs (a tile of
// 8 x 4 on 256 threads ran slower in both dtypes); j is unrolled by 8, the
// window's height, so the rotation is register naming, not moves. B is read
// (128 + W - 1) / 128 times a row (about 2x at W = 128, not 3x). Sums run
// over j in increasing order in the operand dtype.
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
// spmm_band on a bf16 band (a bf16 handle's bandtm form): B and C f32,
// f32 sums, which is what pallas_spmm_band_t computes there: its
// _kernel_mm casts each band column and the B window to the f32 output
// (spmv.py:152, :167-168; a bf16 B rounds nothing on the way to f32). The
// instance is the f32 one with the band in 2-byte values: a chunk holds
// JC = 32 band columns in the f32 chunk's 64 bytes a row, stored as
// column pairs (vs2[jp][r] = v[i0 + r, 2 jp .. 2 jp + 1], one 4-byte
// cp.async a pair, row stride kBandTMS pairs, so a copy instruction's 8
// rows x 4 pairs land on 32 distinct banks as the f32 chunk's do); a
// thread's 8 band values of a pair are two 16-byte loads that serve two
// j. So its rings, its 91,648 bytes of shared memory and its 8 x 8 register
// tiles are the f32 instance's, and the band moves half the bytes. W must
// be even (the planner rounds W up to 8).
//
// Instances (plain C entry points, bound with ctypes):
//   spmm_band_f32      : v f32, B f32, C f32 (f32 accumulation)
//   spmm_band_f64      : v f64, B f64, C f64
//   spmm_band_bf16     : v bf16, B f32, C f32 (f32 accumulation)
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
constexpr int kBandTM = 128;          // spmm_band: rows per CTA (16 groups of 8)
constexpr int kBandCV = 2;            // 16-byte column vectors a thread owns
constexpr int kBandLanes = 16 / kBandCV;  // column lanes: 16 x 16 bytes = a 256-byte chunk of a B row
constexpr int kBandThreads = kBandTM / 8 * kBandLanes;
constexpr int kBandRing = 256;        // B rows of the ring (a power of two)
constexpr int kBandTMS = kBandTM + 8;  // row stride of the j-major band chunk
constexpr int kBandStages = 3;        // band chunks in the ring; B rows run kBandStages - 1 chunks ahead
constexpr int kMB = 128;       // spmm_band_mxu: rows per block
constexpr int kWB = 256;       // window rows per block
constexpr int kCS = 32;        // window rows staged per slice
constexpr int kMxuKC = 64;     // spmm_band_mxu: RHS columns per CTA
constexpr int kMxuStages = 3;  // its cp.async ring

__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }

// ---- cp.async ----------------------------------------------------------------

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

// ---- spmm_band ----------------------------------------------------------------

__device__ __forceinline__ void copy_elem(float* dst, const float* src, bool in) { cp_async4(dst, src, in ? 4 : 0); }
__device__ __forceinline__ void copy_elem(double* dst, const double* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 8 : 0)
               : "memory");
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

// a thread's kBandCV 16-byte vectors of one staged B row: at p and every
// kBandLanes vectors on
template <typename T>
__device__ __forceinline__ void load_row(const T* p, T (&v)[kBandCV * 16 / sizeof(T)]) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < kBandCV; ++u) {
    T t[V];
    load16(p + u * kBandLanes * V, t);
#pragma unroll
    for (int c = 0; c < V; ++c) v[u * V + c] = t[c];
  }
}

// T: B's, C's and the sums' dtype; VT: the band's (T, or bf16 with T f32)
template <typename T, typename VT>
struct BandCfg {
  static constexpr int V = 16 / sizeof(T);                // columns of a 16-byte vector
  static constexpr int KC = 16 * V;                       // columns a CTA owns
  static constexpr int JC = 64 / static_cast<int>(sizeof(VT));  // band columns j a chunk: 32 bf16, 16 f32, 8 f64
  static constexpr int kRingBytes = kBandRing * KC * static_cast<int>(sizeof(T));
  static constexpr int kChunkBytes = JC * kBandTMS * static_cast<int>(sizeof(VT));
  static constexpr int kSmem = kRingBytes + kBandStages * kChunkBytes;  // 91,648 bytes in every instance
  // the rows one chunk reads and the rows of the chunks in flight fit the ring
  static_assert(kBandStages * JC + kBandTM - 1 <= kBandRing, "B ring too small");
};

// cp.async of chunk q: the band values vs[jl][r] = v[i0 + r, q JC + jl]
// (zero past the tile's rows and past W; a copy instruction's 32 lanes take
// 8 rows x 4 consecutive j), and the chunk's new B rows of the ring:
// chunk 0 rows [0, JC + kBandTM - 1), chunk q > 0 rows [q JC + kBandTM - 1,
// (q + 1) JC + kBandTM - 1) of the tile's window (zero outside [0, n) and
// past column K), row t at ring slot t % kBandRing.
template <typename T, typename VT>
__device__ __forceinline__ void band_stage(T* ring, VT* vs, const VT* __restrict__ v, const T* __restrict__ B,
                                           int q, int64_t i0, int nrows, int W, int64_t brow0, int64_t n,
                                           int64_t K, int64_t k0, bool bvec) {
  using L = BandCfg<T, VT>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a copy takes one band value (f32, f64) or a column pair (bf16)
  constexpr int kPer = sizeof(VT) == 2 ? 2 : 1;
  constexpr int kRowGroups = kBandTM / 8, kCombos = kRowGroups * (L::JC / kPer / 4), kWarps = kBandThreads / 32;
#pragma unroll
  for (int k = 0; k < kCombos / kWarps; ++k) {
    const int combo = warp + kWarps * k;
    const int r = (combo % kRowGroups) * 8 + (lane >> 2);
    const int jl = (combo / kRowGroups) * 4 + (lane & 3);  // the value's j, or the pair's
    const int j = q * L::JC + jl * kPer;
    const bool in = r < nrows && j < W;
    if constexpr (kPer == 2)
      cp_async4(vs + (jl * kBandTMS + r) * 2, in ? v + (i0 + r) * W + j : v, in ? 4 : 0);
    else
      copy_elem(vs + jl * kBandTMS + r, in ? v + (i0 + r) * W + j : v, in);
  }
  const int t0 = q == 0 ? 0 : q * L::JC + kBandTM - 1;
  const int t1 = (q + 1) * L::JC + kBandTM - 1;
  if (bvec) {
    for (int e = tid; e < (t1 - t0) * 16; e += kBandThreads) {
      const int t = t0 + e / 16, l = e % 16;
      const int64_t br = brow0 + t, col = k0 + l * L::V;
      const bool in = br >= 0 && br < n && col < K;
      cp_async16(ring + (t & (kBandRing - 1)) * L::KC + l * L::V, in ? B + br * K + col : B, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < (t1 - t0) * L::KC; e += kBandThreads) {
      const int t = t0 + e / L::KC, c = e % L::KC;
      const int64_t br = brow0 + t, col = k0 + c;
      const bool in = br >= 0 && br < n && col < K;
      copy_elem(ring + (t & (kBandRing - 1)) * L::KC + c, in ? B + br * K + col : B, in);
    }
  }
}

// the band values of rows g8 .. g8 + 7 at chunk column jl: two (f64: four)
// 16-byte loads of the j-major chunk; bf16: two 16-byte loads of the
// column pair's 8 rows, widened (a bf16 is the top half of its f32)
template <typename T>
__device__ __forceinline__ void band_vals(const T* vsq, int jl, int g8, T (&val)[8]) {
  constexpr int V = 16 / sizeof(T);
  const T* vj = vsq + jl * kBandTMS + g8;
#pragma unroll
  for (int a = 0; a < 8; a += V) {
    T t[V];
    load16(vj + a, t);
#pragma unroll
    for (int c = 0; c < V; ++c) val[a + c] = t[c];
  }
}
__device__ __forceinline__ void band_vals(const __nv_bfloat16* vsq, int jl, int g8, float (&val)[8]) {
  const uint4* p = reinterpret_cast<const uint4*>(vsq + ((jl >> 1) * kBandTMS + g8) * 2);
  const uint4 u0 = p[0], u1 = p[1];
  const uint32_t w[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
  for (int a = 0; a < 8; ++a) val[a] = __uint_as_float((jl & 1) ? (w[a] & 0xffff0000u) : (w[a] << 16));
}

// The FMAs of chunk q (its first jn <= JC band columns; kFull: jn == JC)
// into the thread's 8 x CV sums, sliding the register window one B row a j.
template <typename T, typename VT, bool kFull>
__device__ __forceinline__ void band_chunk(const T* ring, const VT* vsq, int q, int jn, int g8, int lane,
                                           T (&acc)[8][kBandCV * 16 / sizeof(T)],
                                           T (&win)[8][kBandCV * 16 / sizeof(T)]) {
  using L = BandCfg<T, VT>;
  constexpr int V = L::V, KC = L::KC, JC = L::JC, CV = kBandCV * V;
#pragma unroll
  for (int jb = 0; jb < JC; jb += 8) {
    if (!kFull && jb >= jn) break;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if (!kFull && jb + jj >= jn) break;
      const int j = q * JC + jb + jj;
      load_row(ring + ((g8 + j + 7) & (kBandRing - 1)) * KC + lane * V, win[(jj + 7) & 7]);
      T val[8];
      band_vals(vsq, jb + jj, g8, val);
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < CV; ++c) acc[a][c] = mul_add(val[a], win[(jj + a) & 7][c], acc[a][c]);
    }
  }
}

template <typename T, typename VT>
__global__ void __launch_bounds__(kBandThreads, 2)
spmm_band_kernel(const VT* __restrict__ v, const T* __restrict__ B, T* __restrict__ C, int64_t m,
                 int64_t n, int64_t K, int W, int64_t start, int64_t padL, int bvec) {
  using L = BandCfg<T, VT>;
  constexpr int V = L::V, KC = L::KC, JC = L::JC;
  extern __shared__ __align__(128) unsigned char band_smem[];
  T* ring = reinterpret_cast<T*>(band_smem);
  VT* vs0 = reinterpret_cast<VT*>(band_smem + L::kRingBytes);
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kBandTM;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * KC;
  const int nrows = static_cast<int>(m - i0 < kBandTM ? m - i0 : kBandTM);
  const int64_t brow0 = start + i0 - padL;
  const int nq = (W + JC - 1) / JC;
  const int g8 = (threadIdx.x / kBandLanes) * 8, lane = threadIdx.x % kBandLanes;
  constexpr int CV = kBandCV * V;  // columns a thread owns: vector u at lane * V + u * kBandLanes * V

  T acc[8][CV], win[8][CV];  // win[(j + a) % 8] = B window row g8 + a + j at step j
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < CV; ++c) acc[a][c] = static_cast<T>(0);
#pragma unroll
  for (int k = 0; k < kBandStages - 1; ++k) {
    if (k < nq) band_stage<T, VT>(ring, vs0 + k * JC * kBandTMS, v, B, k, i0, nrows, W, brow0, n, K, k0, bvec);
    cp_async_commit();
  }
  for (int q = 0; q < nq; ++q) {
    cp_async_wait<kBandStages - 2>();
    __syncthreads();  // chunk q landed; every thread is done with chunk q - 1, whose stage is next
    const int qn = q + kBandStages - 1;
    if (qn < nq)
      band_stage<T, VT>(ring, vs0 + (qn % kBandStages) * JC * kBandTMS, v, B, qn, i0, nrows, W, brow0, n, K, k0,
                        bvec);
    cp_async_commit();
    if (q == 0) {
#pragma unroll
      for (int k = 0; k < 7; ++k) load_row(ring + (g8 + k) * KC + lane * V, win[k]);
    }
    const VT* vsq = vs0 + (q % kBandStages) * JC * kBandTMS;
    const int jn = min(JC, W - q * JC);
    if (jn == JC)  // every chunk but a ragged last one: no bound checks in the loop
      band_chunk<T, VT, true>(ring, vsq, q, jn, g8, lane, acc, win);
    else
      band_chunk<T, VT, false>(ring, vsq, q, jn, g8, lane, acc, win);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int64_t i = i0 + g8 + a;
    if (i >= m) break;
#pragma unroll
    for (int u = 0; u < kBandCV; ++u) {
      const int64_t c0 = k0 + lane * V + u * kBandLanes * V;
      if (K % V == 0 && c0 < K) {
        T o[V];
#pragma unroll
        for (int c = 0; c < V; ++c) o[c] = acc[a][u * V + c];
        store16(C + i * K + c0, o);
      } else {
#pragma unroll
        for (int c = 0; c < V; ++c)
          if (c0 + c < K) C[i * K + c0 + c] = acc[a][u * V + c];
      }
    }
  }
}

// ---- spmm_band_mxu ----------------------------------------------------------

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

template <typename T, typename VT>
int launch_band(const void* v, const void* B, void* C, int64_t m, int64_t n, int64_t K, int64_t W,
                int64_t start, int64_t padL, void* stream) {
  if (m <= 0 || K <= 0) return 0;
  // the bf16 band moves in 4-byte column pairs
  if (sizeof(VT) == 2 && (W % 2 || reinterpret_cast<uintptr_t>(v) % 4)) return static_cast<int>(cudaErrorInvalidValue);
  using L = BandCfg<T, VT>;
  cudaError_t err =
      cudaFuncSetAttribute(spmm_band_kernel<T, VT>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bvec = K % L::V == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  const dim3 grid(static_cast<unsigned>((m + kBandTM - 1) / kBandTM),
                  static_cast<unsigned>((K + L::KC - 1) / L::KC));
  spmm_band_kernel<T, VT><<<grid, kBandThreads, L::kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const VT*>(v), static_cast<const T*>(B), static_cast<T*>(C), m, n, K,
      static_cast<int>(W), start, padL, bvec);
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
  return launch_band<float, float>(v, B, C, m, n, K, W, start, padL, stream);
}

int spmm_band_f64(const void* v, const void* B, void* C, int64_t m, int64_t n, int64_t K,
                  int64_t W, int64_t start, int64_t padL, void* stream) {
  return launch_band<double, double>(v, B, C, m, n, K, W, start, padL, stream);
}

int spmm_band_bf16(const void* v, const void* B, void* C, int64_t m, int64_t n, int64_t K,
                   int64_t W, int64_t start, int64_t padL, void* stream) {
  return launch_band<float, __nv_bfloat16>(v, B, C, m, n, K, W, start, padL, stream);
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
