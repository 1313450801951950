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
// WC = 1072, 5 streams, nblk = 489): the band products count 39.2 GFLOP,
// zeros included (0.585 ms at 67 TFLOP/s), but the operands' bands are
// mostly zero: only 23 % of the warp steps below (650,671 of 2,810,240)
// meet a nonzero on both sides, 10.7 GFLOP (0.159 ms). Its bytes (140 + 140
// MB in, 268 MB of C out) take 0.164 ms at 3350 GB/s. The f32 instance is
// exact f32 FMA on the CUDA cores, no TF32: the JAX package pins
// Precision.HIGHEST (spgemm.py:85-94), and the tensor cores take f32 only
// as TF32. The f64 instance runs on the f64 tensor cores (DMMA, mma.sync
// m8n8k4: 67 TFLOP/s against 33.5 on the CUDA cores), whose products are
// IEEE f64 FMAs in another order.
//
// Design: a CTA of 8 warps owns a 64 x 128 tile of one C_g and walks the
// slab chunks (kKC = 32 slab rows) of the streams whose column span
// [G*s, G*s+WB) meets it, in stream order, through a cp.async ring (3
// stages f32, 2 f64) in dynamic shared memory: A's 64 tile rows x 32 slab
// columns as they lie (As[row][k]) and B's 32 slab rows x the tile's 128
// columns, zero-filled outside the group, the slab and the stream's
// columns, 16 bytes a copy where the offsets allow. Warp w owns a 32 x 32
// sub-tile (rows 32 (w / 4), columns 32 (w % 4)). When a chunk lands, the
// CTA reads it once (16 bytes a thread and a load) and votes: for each
// step of kKS = 8 slab rows, whether each warp row group's A fragment (32
// x 8) and each column group's B fragment (8 x 32) holds a nonzero. A warp
// runs a step only if both of its fragments do. The decision comes from
// the values, so no plan-time mask exists and update_values needs no new
// state; the accumulators start at zero, so every C element is still
// written. A skipped step adds only products with a zero factor, so the
// result is the full product's, except where such a zero meets an Inf or
// NaN (0 * Inf is NaN in the full product, absent here).
//   f32 step: lane (lane / 8, lane % 8) owns 8 rows x 4 columns; per 4
//   slab rows 8 16-byte A loads (a row's 4 values each) and 4 of B feed 128
//   FMAs, summed in increasing slab row.
//   f64 step: 4 x 4 DMMA products of 8 x 8 x 4 a warp, fed by one 8-byte
//   load a lane and fragment; the ring's rows are padded by 32 bytes so
//   these loads are conflict-free.
// No atomics on C: a C element belongs to one thread of one CTA. The grid
// walks a group's tiles before the next group's, so the CTAs that share A_g
// run together and find it in L2.
//
// Instances (plain C entry points, bound with ctypes):
//   band_gemm_f32 : A, B, C float32, f32 accumulation
//   band_gemm_f64 : A, B, C float64
// Each takes the streams as a host array of 3 * nstream int32 (rho_lo,
// rho_hi, br_lo), launches once on the given stream, does not synchronise,
// allocates nothing, and returns the CUDA error of the attribute call or
// the launch (0 on success).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxStreams = 6;  // the planner's cap (spgemm_band.py)
constexpr int kThreads = 256;   // 8 warps: 2 row groups x 4 column groups
constexpr int kTM = 64;         // C rows a CTA
constexpr int kTN = 128;        // C columns a CTA
constexpr int kKC = 32;         // slab rows a chunk (one ring stage)
constexpr int kKS = 8;          // slab rows a step: the skip's depth
constexpr int kSteps = kKC / kKS;
constexpr int kWarpRows = kTM / 32, kWarpCols = kTN / 32;  // the CTA's warp grid
static_assert(kWarpRows * kWarpCols * 32 == kThreads, "one 32 x 32 sub-tile a warp");
static_assert(kWarpRows * kSteps <= 32 && kSteps * kWarpCols <= 32, "the votes fit a word each");

struct Streams {
  int n;
  int lo[kMaxStreams];
  int hi[kMaxStreams];
  int br[kMaxStreams];
  int avec[kMaxStreams];  // A's slab columns start on a 16-byte boundary
  int bvec;               // B's rows and the streams' C columns do
};

// The ring: per stage A's tile rows x chunk columns as they lie, As[row][k]
// (row stride kAS), and B's chunk rows x the tile's columns, Bs[k][col]
// (row stride kBS). f64 pads both rows by 32 bytes, so that the tensor
// cores' fragment loads (8 rows x 4 columns of A, 4 rows x 8 columns of B
// a warp) hit distinct banks.
template <typename T>
struct Ring {
  static constexpr int kStages = sizeof(T) == 4 ? 3 : 2;
  static constexpr int kAS = kKC + (sizeof(T) == 4 ? 0 : 4);
  static constexpr int kBS = kTN + (sizeof(T) == 4 ? 0 : 4);
  static constexpr int kA = kTM * kAS;
  static constexpr int kB = kKC * kBS;
  static constexpr int kSmem = kStages * (kA + kB) * static_cast<int>(sizeof(T));
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes, of which the first `bytes` come from src and the rest are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}
// one value, or a zero
__device__ __forceinline__ void cp_async1(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async1(double* dst, const double* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// whether one 16-byte shared vector (4 f32, 2 f64) holds a nonzero
__device__ __forceinline__ bool nonzero16(const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  return q.x != 0.0f || q.y != 0.0f || q.z != 0.0f || q.w != 0.0f;
}
__device__ __forceinline__ bool nonzero16(const double* p) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  return q.x != 0.0 || q.y != 0.0;
}

// A warp's 32 x 32 C tile (rows wr.., columns wc.. of the CTA's tile).
template <typename T>
struct WarpTile;

// f32, exact FMA on the CUDA cores: lane (lane / 8, lane % 8) owns rows
// ar + u (u < 8) and columns bc + v (v < 4); per 4 slab rows, 8 16-byte A
// loads (a row's 4 values each, one address a quarter-warp) and 4 of B feed
// 128 FMAs, summed in increasing slab row.
template <>
struct WarpTile<float> {
  using R = Ring<float>;
  float acc[8][4];
  int ar, bc;
  __device__ __forceinline__ WarpTile(int wr, int wc, int lane) : ar(wr + 8 * (lane >> 3)), bc(wc + 4 * (lane & 7)) {
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
  }
  __device__ __forceinline__ void step(const float* as, const float* bs, int t) {
#pragma unroll
    for (int k4 = kKS * t; k4 < kKS * (t + 1); k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) a[u] = *reinterpret_cast<const float4*>(as + (ar + u) * R::kAS + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b = *reinterpret_cast<const float4*>(bs + (k4 + kk) * R::kBS + bc);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float av = kk == 0 ? a[u].x : kk == 1 ? a[u].y : kk == 2 ? a[u].z : a[u].w;
          acc[u][0] = fmaf(av, b.x, acc[u][0]);
          acc[u][1] = fmaf(av, b.y, acc[u][1]);
          acc[u][2] = fmaf(av, b.z, acc[u][2]);
          acc[u][3] = fmaf(av, b.w, acc[u][3]);
        }
      }
    }
  }
  __device__ __forceinline__ void store(float* Cg, int G, int WC, int r0, int c0) const {
    const int c = c0 + bc;
    const bool cvec = (WC & 3) == 0 && c + 3 < WC;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int r = r0 + ar + u;
      if (r >= G) break;
      float* p = Cg + static_cast<size_t>(r) * WC + c;
      if (cvec) {
        *reinterpret_cast<float4*>(p) = make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (c + v < WC) p[v] = acc[u][v];
      }
    }
  }
};

// f64 on the tensor cores (DMMA, mma.sync m8n8k4 f64): the warp's tile is
// 4 x 4 products of 8 x 8, each over 4 slab rows; lane l holds A[8 mi + l
// / 4][k + l % 4], B[k + l % 4][8 ni + l / 4] and C[8 mi + l / 4][8 ni + 2
// (l % 4) + {0, 1}].
template <>
struct WarpTile<double> {
  using R = Ring<double>;
  double acc[4][4][2];
  int ar, bc, lane;
  __device__ __forceinline__ WarpTile(int wr, int wc, int lane_) : ar(wr), bc(wc), lane(lane_) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;
  }
  __device__ __forceinline__ void step(const double* as, const double* bs, int t) {
    const int gr = lane >> 2, q = lane & 3;
#pragma unroll
    for (int k4 = kKS * t; k4 < kKS * (t + 1); k4 += 4) {
      double a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[(ar + 8 * i + gr) * R::kAS + k4 + q];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[(k4 + q) * R::kBS + bc + 8 * j + gr];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
                       : "+d"(acc[i][j][0]), "+d"(acc[i][j][1])
                       : "d"(a[i]), "d"(b[j]));
    }
  }
  __device__ __forceinline__ void store(double* Cg, int G, int WC, int r0, int c0) const {
    const int gr = lane >> 2, q = lane & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ar + 8 * i + gr;
      if (r >= G) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + bc + 8 * j + 2 * q;
        double* p = Cg + static_cast<size_t>(r) * WC + c;
        if ((WC & 1) == 0 && c + 1 < WC) {
          *reinterpret_cast<double2*>(p) = make_double2(acc[i][j][0], acc[i][j][1]);
        } else {
          if (c < WC) p[0] = acc[i][j][0];
          if (c + 1 < WC) p[1] = acc[i][j][1];
        }
      }
    }
  }
};

// The CTA's chunk list: chunk i belongs to stream s with first[s] <= i <
// first[s + 1] (streams that miss the tile hold no chunk).
struct Chunks {
  int first[kMaxStreams + 1];
  int lo[kMaxStreams], hi[kMaxStreams], br[kMaxStreams], avec[kMaxStreams];
};

// cp.async of chunk i into stage (as, bs): A_g rows r0.. and slab columns
// k0.., B_{g+d0+s} slab rows and the tile's columns, zeros outside the
// group, the slab and the stream's columns
template <typename T>
__device__ __forceinline__ void stage_chunk(T* as, T* bs, const Chunks& ch, int i, const T* __restrict__ Ag,
                                            const T* __restrict__ B, int g, int d0, int G, int WA, int WB, int r0,
                                            int c0, int bvec) {
  using R = Ring<T>;
  constexpr int V = 16 / sizeof(T);
  int s = 0;
#pragma unroll
  for (int t = 1; t < kMaxStreams; ++t) s += i >= ch.first[t];
  const int lo = ch.lo[s], hi = ch.hi[s];
  const int k0 = lo + (i - ch.first[s]) * kKC;
  const T* Bg = B + static_cast<size_t>(g + d0 + s) * G * WB;
  const int bc0 = c0 - G * s;      // B column of the tile's column 0
  const int brow = ch.br[s] - lo;  // B row of slab column k: brow + k
  if (ch.avec[s]) {
#pragma unroll
    for (int j = 0; j < kTM * kKC / V / kThreads; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int r = e / (kKC / V), k = (e - r * (kKC / V)) * V;
      const int kk = k0 + k, left = hi - kk;
      const bool in = r0 + r < G && left > 0;
      cp_async16(as + r * R::kAS + k, in ? Ag + static_cast<size_t>(r0 + r) * WA + kk : Ag,
                 in ? (left < V ? left : V) * static_cast<int>(sizeof(T)) : 0);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < kTM * kKC / kThreads; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int r = e / kKC, k = e - r * kKC;
      const bool in = r0 + r < G && k0 + k < hi;
      cp_async1(as + r * R::kAS + k, in ? Ag + static_cast<size_t>(r0 + r) * WA + k0 + k : Ag, in);
    }
  }
  if (bvec) {
#pragma unroll
    for (int j = 0; j < kKC * kTN / V / kThreads; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int k = e / (kTN / V), c = (e - k * (kTN / V)) * V;
      const int bcol = bc0 + c;
      const bool in = k0 + k < hi && bcol >= 0 && bcol < WB;
      cp_async16(bs + k * R::kBS + c, in ? Bg + static_cast<size_t>(brow + k0 + k) * WB + bcol : Bg, in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < kKC * kTN / kThreads; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int k = e / kTN, c = e - k * kTN;
      const int bcol = bc0 + c;
      const bool in = k0 + k < hi && bcol >= 0 && bcol < WB;
      cp_async1(bs + k * R::kBS + c, in ? Bg + static_cast<size_t>(brow + k0 + k) * WB + bcol : Bg, in);
    }
  }
}

// The vote on a landed chunk: bit kSteps rg + t of the A word if A's
// fragment of row group rg (32 rows) and step t (8 slab columns) holds a
// nonzero, bit kWarpCols t + cg of the B word likewise for B's step t and
// column group cg (32 columns). The
// CTA reads the chunk once, 16 bytes a thread and a load, conflict-free,
// and ORs the bits of each warp into votes[0], votes[1].
template <typename T>
__device__ __forceinline__ void vote_chunk(const T* as, const T* bs, unsigned* votes) {
  using R = Ring<T>;
  constexpr int V = 16 / sizeof(T);
  unsigned abits = 0, bbits = 0;
#pragma unroll 4  // f64: 8 loads, not all in flight beside the accumulators
  for (int j = 0; j < kTM * kKC / V / kThreads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int r = e / (kKC / V), k = (e - r * (kKC / V)) * V;
    abits |= nonzero16(as + r * R::kAS + k) ? 1u << (kSteps * (r / 32) + k / kKS) : 0u;
  }
#pragma unroll 4
  for (int j = 0; j < kKC * kTN / V / kThreads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int k = e / (kTN / V), c = (e - k * (kTN / V)) * V;
    bbits |= nonzero16(bs + k * R::kBS + c) ? 1u << (kWarpCols * (k / kKS) + c / 32) : 0u;
  }
  abits = __reduce_or_sync(0xffffffffu, abits);
  bbits = __reduce_or_sync(0xffffffffu, bbits);
  if ((threadIdx.x & 31) == 0) {
    if (abits) atomicOr(votes, abits);
    if (bbits) atomicOr(votes + 1, bbits);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)  // two CTAs an SM, both instances
band_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C, int nblk, int G, int WA,
                 int WB, int WC, int d0, int nrow, int ncol, Streams st) {
  using R = Ring<T>;
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  __shared__ Chunks ch;
  __shared__ unsigned votes[2][2];  // [chunk parity][A, B]
  T* ring = reinterpret_cast<T*>(gemm_smem);
  // the grid walks a group's row and column tiles before the next group,
  // so the CTAs that read A_g run together and find it in L2
  const int per_g = nrow * ncol;
  const int g = blockIdx.x / per_g;
  const int rt = (blockIdx.x - g * per_g) / ncol;
  const int r0 = rt * kTM, c0 = (blockIdx.x - g * per_g - rt * ncol) * kTN;
  if (threadIdx.x == 0) {
    int nch = 0;
#pragma unroll
    for (int s = 0; s < kMaxStreams; ++s) {
      ch.first[s] = nch;
      const int lo = st.lo[s], hi = st.hi[s], gb = g + d0 + s, cs = G * s;
      const bool meets = s < st.n && hi > lo && gb >= 0 && gb < nblk && cs < c0 + kTN && cs + WB > c0;
      ch.lo[s] = lo, ch.hi[s] = hi, ch.br[s] = st.br[s], ch.avec[s] = st.avec[s];
      nch += meets ? (hi - lo + kKC - 1) / kKC : 0;
    }
    ch.first[kMaxStreams] = nch;
    votes[0][0] = votes[0][1] = 0u;
  }
  __syncthreads();
  const int nch = ch.first[kMaxStreams];
  const T* Ag = A + static_cast<size_t>(g) * G * WA;
  const int warp = threadIdx.x >> 5;
  const int wr = 32 * (warp / kWarpCols), wc = 32 * (warp % kWarpCols);  // the warp's tile in the CTA's
  WarpTile<T> tile(wr, wc, threadIdx.x & 31);

#pragma unroll
  for (int i = 0; i < R::kStages - 1; ++i) {
    if (i < nch)
      stage_chunk<T>(ring + i * (R::kA + R::kB), ring + i * (R::kA + R::kB) + R::kA, ch, i, Ag, B, g, d0, G, WA,
                     WB, r0, c0, st.bvec);
    cp_async_commit();
  }
  for (int i = 0; i < nch; ++i) {
    cp_async_wait<R::kStages - 2>();
    __syncthreads();  // chunk i landed; every warp is done with chunk i - 1
    const int in = i + R::kStages - 1;
    if (in < nch) {
      T* sa = ring + (in % R::kStages) * (R::kA + R::kB);
      stage_chunk<T>(sa, sa + R::kA, ch, in, Ag, B, g, d0, G, WA, WB, r0, c0, st.bvec);
    }
    cp_async_commit();
    const T* as = ring + (i % R::kStages) * (R::kA + R::kB);
    const T* bs = as + R::kA;
    vote_chunk<T>(as, bs, votes[i & 1]);
    if (threadIdx.x == 0) votes[(i + 1) & 1][0] = votes[(i + 1) & 1][1] = 0u;
    __syncthreads();  // the votes are in
    const unsigned va = votes[i & 1][0] >> (kSteps * (wr / 32)), vb = votes[i & 1][1] >> (wc / 32);
#pragma unroll
    for (int t = 0; t < kSteps; ++t)
      if ((va >> t) & (vb >> (kWarpCols * t)) & 1u) tile.step(as, bs, t);  // warp-uniform
  }
  cp_async_wait<0>();
  tile.store(C + static_cast<size_t>(g) * G * WC, G, WC, r0, c0);
}

template <typename T>
int launch(const void* A, const void* B, void* C, int64_t nblk, int64_t G, int64_t WA, int64_t WB,
           int64_t WC, int64_t d0, const int32_t* ranges, int64_t nstream, void* stream) {
  if (nblk <= 0 || G <= 0 || WC <= 0) return 0;
  if (nstream < 0 || nstream > kMaxStreams) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(T);
  const bool a16 = reinterpret_cast<uintptr_t>(A) % 16 == 0, b16 = reinterpret_cast<uintptr_t>(B) % 16 == 0;
  Streams st{};
  st.n = static_cast<int>(nstream);
  for (int s = 0; s < st.n; ++s) {
    st.lo[s] = ranges[3 * s];
    st.hi[s] = ranges[3 * s + 1];
    st.br[s] = ranges[3 * s + 2];
    st.avec[s] = a16 && WA % V == 0 && st.lo[s] % V == 0;
  }
  st.bvec = b16 && WB % V == 0 && G % V == 0;
  const int64_t nrow = (G + kTM - 1) / kTM, ncol = (WC + kTN - 1) / kTN;
  if (nblk * nrow * ncol > INT_MAX || G * WC > INT_MAX || G * WA > INT_MAX || G * WB > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Ring<T>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(band_gemm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  band_gemm_kernel<T><<<static_cast<unsigned>(nblk * nrow * ncol), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<T*>(C), static_cast<int>(nblk),
      static_cast<int>(G), static_cast<int>(WA), static_cast<int>(WB), static_cast<int>(WC),
      static_cast<int>(d0), static_cast<int>(nrow), static_cast<int>(ncol), st);
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
