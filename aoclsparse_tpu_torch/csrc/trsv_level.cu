// Level-scheduled sparse triangular solve for NVIDIA Hopper (sm_90a): sv
// KID 1, the solve of the planner's LevelForm (kernels/trsv_level.py), with
// K right-hand sides. For every row i of a lower-oriented triangle, in an
// order that respects its levels:
//
//   x[i] = (b[i] - sum_{j < i} L[i, j] * x[j]) * dinv[i]
//
// over the form's compact level-ordered CSR: position p = 0..m-1 walks the
// rows level by level; lrow[p] is the row, lptr[p]..lptr[p+1] its strict
// entries (lcol int32, lval), dinv[p] its inverted diagonal (1 for a unit
// triangle). Rows and columns are in the caller's index space (an upper
// source's reversal is folded into them), so B and X are the caller's
// row-major (m, K) arrays. Every strict entry is multiplied as stored, a
// zero included, so an Inf or NaN in solved x meets it as in the plain
// version (kernels/trsv_level.py level_step).
//
// Stands for the JAX package's XLA level loops (no Pallas kernel there):
//   aoclsparse_tpu/kernels/xla/trsv_level.py:138  _solve_levels_jit
//   aoclsparse_tpu/kernels/xla/trsv_level.py:157  _solve_runs_jit
//
// What bounds it: not bytes. The 104^3 stencil's ILU0 L factor (14.3M
// strict entries, 1.12M rows) moves about 0.13 GB, 0.04 ms at 3.35 TB/s,
// but its 722 levels are 722 dependent hops: a row can start only when the
// rows it reads, written by other SMs, are visible to it. The card's floor
// for one hop between two SMs is one store and one load through L2
// (trsv_level_hop_probe below; scripts/level_bench.py measures it).
//
// Design. The first design of this kernel made a hop a release store of a
// flag after x, an acquire poll with a fixed 32 ns sleep between polls and
// a second trip to L2 for x. Here:
//
// * The deal. A cooperative grid of G CTAs of 16 warps, every warp
//   resident; warp w of the grid takes positions w, w + 16 G, w + 32 G, ...
//   of the level order, one row a warp. G is the host's (kernels/
//   trsv_level.py grid_for): a few warps a row of the mean level, so that
//   each warp has a few levels' time for its loads, and not more, since
//   every waiting warp polls L2.
// * Value-carried readiness for K = 1. A row's value travels in 64-bit
//   words (words[row * NWD + i], NWD = sizeof(T) / 4), each a 32-bit slice
//   of the value beside the launch's 32-bit epoch, written by one
//   st.relaxed.gpu.b64 each. The PTX memory model makes a naturally aligned
//   64-bit scalar access single-copy atomic (a vector access is not: it is
//   several scalar ones), so a reader that sees the epoch in a word sees
//   that word's slice of this launch's value: f32 is one word, f64 and
//   complex64 two, complex128 four, each slice checked by its own epoch.
//   No fence and no second trip: a hop is one store and the reads of the
//   words. X is still written, in the caller's layout, for the caller.
//   Lane l of the row's warp polls and multiplies entries l, l + 32, ...
//   in order; the lanes meet in a fixed 5-step xor butterfly.
// * Columns across lanes for K > 1 (trsm, 2-D smoothers). K values a row do
//   not fit such words, so a row keeps a ready flag, stored with
//   st.release.gpu by lane 0 after the warp's X stores and a __syncwarp.
//   Lane l polls the flags of entries l, l + 32, ... (ld.acquire.gpu), the
//   warp meets at a __syncwarp, and lane q then sums column c0 + q over the
//   row's entries in order (each entry's column and value passed by
//   shuffle, x[col, c0 + q] read past L1 by ld.global.cg, a coalesced row
//   of x a warp, eight loads in flight, four for complex128), 32 columns a
//   pass: no butterfly.
// * The next row's (row, beg, end) and the lanes' first entries are loaded
//   before a row waits, so a warp's loads overlap its waits.
// * A poll spins: measured on the card, any sleep between polls (32 to
//   1,024 ns, growing or fixed) made every triangle slower. Every 256th
//   poll reads %globaltimer, and a wait past kMaxWaitNs traps, so a
//   malformed form fails the launch instead of hanging the card.
//
// The same bits whatever the grid and the order the warps run in: a row's
// sum order is fixed by its entries alone (K = 1: lanes and butterfly;
// K > 1: in order). No deadlock: every warp is resident and walks its
// positions in increasing order, and a row waits only on rows of lower
// levels, so of lower positions; the unsolved row of lowest position is
// the current row of its warp (all its earlier rows have lower positions
// and are solved), and all its inputs are solved, so it completes. The
// epoch is a per-form counter passed at launch, so words and flags need no
// reset launch (the caller zeroes them when it wraps).
//
// Tried on the card and dropped (PERF.md, Findings): parts of contiguous rows
// a CTA with in-CTA hops through shared memory (a part's workers then do
// about a row a level each, and each row's dependent loads set the pace:
// 1.5-2.6 ms on the stencil's L against 0.81 dealt, on an H100 at 700 W);
// 16 lanes a row, two rows a warp (the two halves' waits serialise: 1.76
// against 0.86 ms); sleeps between polls; earlier, a ticket from an atomic,
// a grid barrier a level and 8 lanes a row.
//
// Instances (plain C entry points, bound with ctypes):
//   trsv_level_f32, trsv_level_f64, trsv_level_c64, trsv_level_c128
// Each launches one kernel on the given stream, does not synchronise,
// allocates nothing, adds 1 to *launches, and returns the first CUDA error
// of the launch (0 on success; cudaErrorInvalidValue for arguments out of
// range). trsv_level_occupancy reports an instance's resident CTAs an SM;
// trsv_level_hop_probe measures one hop.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// the longest a poll may wait before the kernel traps
constexpr unsigned long long kMaxWaitNs = 4000000000ull;

// the value arithmetic of the kernel, real and complex (float2 / double2:
// x the real part, y the imaginary part)
__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float2 mul_add(float2 a, float2 b, float2 c) {
  return make_float2(fmaf(a.x, b.x, fmaf(-a.y, b.y, c.x)), fmaf(a.x, b.y, fmaf(a.y, b.x, c.y)));
}
__device__ __forceinline__ double2 mul_add(double2 a, double2 b, double2 c) {
  return make_double2(fma(a.x, b.x, fma(-a.y, b.y, c.x)), fma(a.x, b.y, fma(a.y, b.x, c.y)));
}
template <typename T>
__device__ __forceinline__ T zero() { return T(0); }
template <>
__device__ __forceinline__ float2 zero<float2>() { return make_float2(0.f, 0.f); }
template <>
__device__ __forceinline__ double2 zero<double2>() { return make_double2(0.0, 0.0); }
// the value of lane `src`
__device__ __forceinline__ float shfl(float a, int src) { return __shfl_sync(kFull, a, src); }
__device__ __forceinline__ double shfl(double a, int src) { return __shfl_sync(kFull, a, src); }
__device__ __forceinline__ float2 shfl(float2 a, int src) { return make_float2(shfl(a.x, src), shfl(a.y, src)); }
__device__ __forceinline__ double2 shfl(double2 a, int src) { return make_double2(shfl(a.x, src), shfl(a.y, src)); }
// a + the value of lane (lane ^ s)
__device__ __forceinline__ float shfl_add(float a, int s) { return a + __shfl_xor_sync(kFull, a, s); }
__device__ __forceinline__ double shfl_add(double a, int s) { return a + __shfl_xor_sync(kFull, a, s); }
__device__ __forceinline__ float2 shfl_add(float2 a, int s) { return make_float2(shfl_add(a.x, s), shfl_add(a.y, s)); }
__device__ __forceinline__ double2 shfl_add(double2 a, int s) {
  return make_double2(shfl_add(a.x, s), shfl_add(a.y, s));
}
// a row's value: (b - sum) * dinv
__device__ __forceinline__ float finish(float b, float acc, float d) { return (b - acc) * d; }
__device__ __forceinline__ double finish(double b, double acc, double d) { return (b - acc) * d; }
__device__ __forceinline__ float2 finish(float2 b, float2 acc, float2 d) {
  const float r = b.x - acc.x, i = b.y - acc.y;
  return make_float2(r * d.x - i * d.y, r * d.y + i * d.x);
}
__device__ __forceinline__ double2 finish(double2 b, double2 acc, double2 d) {
  const double r = b.x - acc.x, i = b.y - acc.y;
  return make_double2(r * d.x - i * d.y, r * d.y + i * d.x);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long ld_acquire64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release64(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned long long ld_relaxed_cta(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.cta.shared.b64 %0, [%1];" : "=l"(v) : "r"(smem_addr(p)));
  return v;
}
__device__ __forceinline__ void st_relaxed_cta(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.cta.shared.b64 [%0], %1;" ::"r"(smem_addr(p)), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the count of one wait's polls; every 256th reads the clock and traps past
// kMaxWaitNs
struct Watch {
  unsigned n = 0;
  unsigned long long t0 = 0;
  __device__ __forceinline__ void poll() {
    if ((++n & 255u) != 0) return;
    const unsigned long long t = now_ns();
    if (t0 == 0) t0 = t;
    else if (t - t0 > kMaxWaitNs) __trap();
  }
};

// the 64-bit words of one value: NWD slices of 32 bits, each beside the epoch
template <typename T>
struct Words {
  static constexpr int n = sizeof(T) / 4;
};

template <typename T>
__device__ __forceinline__ void publish(unsigned long long* w, T v, unsigned epoch) {
  uint32_t u[Words<T>::n];
  memcpy(u, &v, sizeof(T));
  const unsigned long long hi = static_cast<unsigned long long>(epoch) << 32;
#pragma unroll
  for (int i = 0; i < Words<T>::n; ++i) st_relaxed(w + i, hi | u[i]);
}

template <typename T>
__device__ __forceinline__ T await_words(const unsigned long long* w, unsigned epoch) {
  uint32_t u[Words<T>::n];
  Watch watch;
  for (;;) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < Words<T>::n; ++i) {
      const unsigned long long x = ld_relaxed(w + i);
      u[i] = static_cast<uint32_t>(x);
      ok &= static_cast<unsigned>(x >> 32) == epoch;
    }
    if (ok) break;
    watch.poll();
  }
  T v;
  memcpy(&v, u, sizeof(T));
  return v;
}

__device__ __forceinline__ void await_flag(const int* f, int epoch) {
  Watch watch;
  while (ld_acquire(f) != epoch) watch.poll();
}

// a position's row and entries
struct Pos {
  int row, beg, end;
};

__device__ __forceinline__ Pos load_pos(const int32_t* __restrict__ lrow, const int32_t* __restrict__ lptr, int p,
                                        int m) {
  if (p >= m) return Pos{0, 0, 0};
  return Pos{__ldg(lrow + p), __ldg(lptr + p), __ldg(lptr + p + 1)};
}

// what a warp loads of its next row before it waits on the current one
template <typename T>
struct Ahead {
  Pos pos;
  int col;  // the lane's first entry
  T v, b, d;
};

template <typename T>
__device__ __forceinline__ Ahead<T> load_ahead(Pos pos, int p, int m, int lane, const int32_t* __restrict__ lcol,
                                               const T* __restrict__ lval, const T* __restrict__ dinv,
                                               const T* __restrict__ B) {
  Ahead<T> a;
  a.pos = pos;
  const int j = pos.beg + lane;
  const bool has = j < pos.end;
  a.col = has ? __ldg(lcol + j) : 0;
  a.v = has ? __ldg(lval + j) : zero<T>();
  a.b = __ldg(B + pos.row);
  a.d = __ldg(dinv + (p < m ? p : 0));
  return a;
}

// K = 1: readiness words
template <typename T>
__global__ void __launch_bounds__(kThreads)
    level_words_kernel(const int32_t* __restrict__ lrow, const int32_t* __restrict__ lptr,
                       const int32_t* __restrict__ lcol, const T* __restrict__ lval, const T* __restrict__ dinv,
                       const T* __restrict__ B, T* __restrict__ X, unsigned long long* words, int m,
                       unsigned epoch) {
  constexpr int NWD = Words<T>::n;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int stride = static_cast<int>(gridDim.x) * kWarps;
  int p = static_cast<int>(blockIdx.x) * kWarps + static_cast<int>(threadIdx.x) / 32;
  Ahead<T> cur = load_ahead<T>(load_pos(lrow, lptr, p, m), p, m, lane, lcol, lval, dinv, B);
  Pos nxt = load_pos(lrow, lptr, p + stride, m);
  for (; p < m; p += stride) {
    const Pos nn = load_pos(lrow, lptr, p + 2 * stride, m);
    const Ahead<T> ahead = load_ahead<T>(nxt, p + stride, m, lane, lcol, lval, dinv, B);
    T acc = zero<T>();
    for (int j = cur.pos.beg + lane; j < cur.pos.end; j += 32) {
      const bool first = j == cur.pos.beg + lane;
      const int col = first ? cur.col : __ldg(lcol + j);
      const T v = first ? cur.v : __ldg(lval + j);
      acc = mul_add(v, await_words<T>(words + static_cast<int64_t>(col) * NWD, epoch), acc);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) acc = shfl_add(acc, s);
    if (lane == 0) {
      const T x = finish(cur.b, acc, cur.d);
      publish(words + static_cast<int64_t>(cur.pos.row) * NWD, x, epoch);
      X[cur.pos.row] = x;
    }
    cur = ahead;
    nxt = nn;
  }
}

// K > 1: ready flags, columns across lanes (a minimum of one CTA an SM:
// at ptxas's default budget some instances spilled 8-36 bytes)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    level_cols_kernel(const int32_t* __restrict__ lrow, const int32_t* __restrict__ lptr,
                      const int32_t* __restrict__ lcol, const T* __restrict__ lval, const T* __restrict__ dinv,
                      const T* __restrict__ B, T* X, int* ready, int m, int K, int epoch) {
  constexpr int kBatch = sizeof(T) <= 8 ? 8 : 4;  // x loads in flight a lane
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int stride = static_cast<int>(gridDim.x) * kWarps;
  int p = static_cast<int>(blockIdx.x) * kWarps + static_cast<int>(threadIdx.x) / 32;
  Pos nxt = load_pos(lrow, lptr, p, m);
  for (; p < m; p += stride) {
    const Pos pos = nxt;
    nxt = load_pos(lrow, lptr, p + stride, m);
    const T d = __ldg(dinv + p);
    for (int c0 = 0; c0 < K; c0 += 32) {
      const int q = c0 + lane;
      const bool on = q < K;
      T acc = zero<T>();
      for (int t0 = pos.beg; t0 < pos.end; t0 += 32) {
        const int j = t0 + lane;
        const bool has = j < pos.end;
        const int col = has ? __ldg(lcol + j) : 0;
        const T v = has ? __ldg(lval + j) : zero<T>();
        if (c0 == 0 && has) await_flag(ready + col, epoch);
        __syncwarp();
        const int n = pos.end - t0 < 32 ? pos.end - t0 : 32;
        for (int t = 0; t < n; t += kBatch) {
          T xv[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int cj = __shfl_sync(kFull, col, (t + u) & 31);
            xv[u] = on && t + u < n ? __ldcg(X + static_cast<int64_t>(cj) * K + q) : zero<T>();
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const T vj = shfl(v, (t + u) & 31);
            if (t + u < n) acc = mul_add(vj, xv[u], acc);
          }
        }
      }
      if (on) {
        const int64_t o = static_cast<int64_t>(pos.row) * K + q;
        X[o] = finish(__ldg(B + o), acc, d);
      }
    }
    __syncwarp();
    if (lane == 0) st_release(ready + pos.row, epoch);
  }
}

template <typename T>
const void* pick(int64_t K) {
  return K == 1 ? reinterpret_cast<const void*>(level_words_kernel<T>)
                : reinterpret_cast<const void*>(level_cols_kernel<T>);
}

// out = (SMs, resident CTAs an SM) of the instance for K
template <typename T>
int occupancy(int64_t K, int64_t* out) {
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, nsm = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, pick<T>(K), kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  out[0] = nsm, out[1] = occ;
  return 0;
}

template <typename T>
int launch(const void* lrow, const void* lptr, const void* lcol, const void* lval, const void* dinv, const void* B,
           void* X, void* sync, int64_t m, int64_t K, int64_t grid, int64_t epoch, void* stream, int64_t* launches) {
  if (m < 1 || m > INT32_MAX || K < 1 || K > INT32_MAX || grid < 1 || grid > INT32_MAX / kThreads || epoch < 1 ||
      epoch > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int mi = static_cast<int>(m), Ki = static_cast<int>(K);
  cudaError_t err;
  if (K == 1) {
    unsigned ep = static_cast<unsigned>(epoch);
    void* args[] = {&lrow, &lptr, &lcol, &lval, &dinv, &B, &X, &sync, &mi, &ep};
    err = cudaLaunchCooperativeKernel(pick<T>(K), dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, 0,
                                      static_cast<cudaStream_t>(stream));
  } else {
    int ep = static_cast<int>(epoch);
    void* args[] = {&lrow, &lptr, &lcol, &lval, &dinv, &B, &X, &sync, &mi, &Ki, &ep};
    err = cudaLaunchCooperativeKernel(pick<T>(K), dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, 0,
                                      static_cast<cudaStream_t>(stream));
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) *launches += 1;
  return static_cast<int>(err);
}

__device__ __forceinline__ unsigned smid() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}

extern __shared__ __align__(16) unsigned char probe_smem[];

// One hop's floor: thread 0 of CTA 0 and of CTA 1 (on two SMs: each CTA
// takes more than half an SM's shared memory) pass a counter back and forth
// `rounds` times through one 64-bit word of global memory, by relaxed
// (mode 0) or release / acquire (mode 1) accesses at GPU scope; mode 2 is
// two warps of CTA 0 through one 64-bit shared word (relaxed at CTA scope).
// A round is two hops. smids[0..1] report the CTAs' SMs.
__global__ void hop_probe_kernel(unsigned long long* word, unsigned* smids, int rounds, int mode) {
  if (threadIdx.x == 0) smids[blockIdx.x] = smid();
  if (mode == 2) {
    if (blockIdx.x != 0) return;
    unsigned long long* f = reinterpret_cast<unsigned long long*>(probe_smem);
    if (threadIdx.x == 0) *f = 0;
    __syncthreads();
    if (threadIdx.x != 0 && threadIdx.x != 32) return;
    const bool ping = threadIdx.x == 0;
    for (int i = 0; i < rounds; ++i) {
      if (ping) st_relaxed_cta(f, 2ull * i + 1);
      Watch watch;
      while (ld_relaxed_cta(f) != (ping ? 2ull * i + 2 : 2ull * i + 1)) watch.poll();
      if (!ping) st_relaxed_cta(f, 2ull * i + 2);
    }
    return;
  }
  if (threadIdx.x != 0) return;
  const bool ping = blockIdx.x == 0;
  for (int i = 0; i < rounds; ++i) {
    const unsigned long long want = ping ? 2ull * i + 2 : 2ull * i + 1;
    if (ping) {
      if (mode == 0) st_relaxed(word, 2ull * i + 1);
      else st_release64(word, 2ull * i + 1);
    }
    Watch watch;
    while ((mode == 0 ? ld_relaxed(word) : ld_acquire64(word)) != want) watch.poll();
    if (!ping) {
      if (mode == 0) st_relaxed(word, 2ull * i + 2);
      else st_release64(word, 2ull * i + 2);
    }
  }
}

}  // namespace

extern "C" {

// kind: 0 f32, 1 f64, 2 complex64, 3 complex128; out = (SMs, CTAs an SM)
int trsv_level_occupancy(int64_t kind, int64_t K, int64_t* out) {
  switch (kind) {
    case 0: return occupancy<float>(K, out);
    case 1: return occupancy<double>(K, out);
    case 2: return occupancy<float2>(K, out);
    case 3: return occupancy<double2>(K, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#define LEVEL_ENTRY(name, T)                                                                                     \
  int name(const void* lrow, const void* lptr, const void* lcol, const void* lval, const void* dinv, const void* B, \
           void* X, void* sync, int64_t m, int64_t K, int64_t grid, int64_t epoch, void* stream,                \
           int64_t* launches) {                                                                                 \
    return launch<T>(lrow, lptr, lcol, lval, dinv, B, X, sync, m, K, grid, epoch, stream, launches);            \
  }

LEVEL_ENTRY(trsv_level_f32, float)
LEVEL_ENTRY(trsv_level_f64, double)
LEVEL_ENTRY(trsv_level_c64, float2)
LEVEL_ENTRY(trsv_level_c128, double2)

#undef LEVEL_ENTRY

int trsv_level_hop_probe(void* word, void* smids, int64_t rounds, int64_t mode, void* stream) {
  if (rounds < 1 || rounds > (1 << 28) || mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  const void* kern = reinterpret_cast<const void*>(hop_probe_kernel);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  int r = static_cast<int>(rounds), md = static_cast<int>(mode);
  void* args[] = {&word, &smids, &r, &md};
  err = cudaLaunchCooperativeKernel(kern, dim3(2), dim3(64), args, static_cast<size_t>(optin),
                                    static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // extern "C"
