// CSR row-gather SpMV for NVIDIA Hopper (sm_90a), the mv kernel of the
// `segsum` execution form (mv KID 0):
//
//     y[i] = sum_{ptr[i] <= p < ptr[i + 1]} val[p] * x[ind[p]]     (0 <= i < m)
//
// over the planner's CSR (ExecForm.ptr, ind, val); every ind[p] lies in
// [0, n), as the planner's validated CSR holds it.
//
// It replaces no Pallas kernel. It is the hand kernel of the JAX package's
// XLA formulation
//   aoclsparse_tpu/kernels/xla/spmv.py:51  spmv_segsum  (mv KID 0)
// (gather, multiply, segment sum), which the port's planner sends general
// structure to on the card (planner/plan.py choose_mv_format): a scattered
// matrix's CSR moves far fewer bytes than the band of the `gen` composite
// or the routes of the `route` form.
//
// What bounds it: bytes. Each entry is read once, its index and its value
// (nnz * (4 + vsize) with int32 indices), the row pointers once
// ((m + 1) * 4), y written once (m * vsize), and x gathered, one read per
// entry whose line is not already in L2; at 2 flops an entry it is far
// below the card's flop:byte balance. A web graph's x (4 MB at a million
// rows in f32) fits the 50 MB L2, so the gathers mostly hit L2 and the
// stream of ind and val sets the time. Rows are short and uneven (a mean
// of 3 entries on the webbase stand-in, with hub rows of 4,700), so what
// the time depends on is how many bytes each SM has in flight, and that no
// thread waits on a row much longer than its neighbours'.
//
// Design (after CSR-Adaptive, Greathouse and Daga, SC'14): one launch, one
// CTA of kThreads threads a row block of a plan-time schedule
// (kernels/spmv_csr.py `csr_blocks`). A block is a run of whole rows whose
// entries total at most Tile<T>::entries (2,048 for f32, 1,024 for the
// wider types), with at most half as many rows; a row longer than
// LONG_ROW (256) entries is a block of its own. The schedule is a table of
// (first row, first entry) pairs, int64, one a block and one more for the
// end (m, ptr[m]), so a CTA reads its whole range in one load.
// - A block of several rows streams its entry range [s, e) in slots of V
//   entries (V = 16 bytes over the wider of the index and value types):
//   16-byte loads of ind and val where both pointers are 16-byte aligned,
//   scalar loads for the head and tail slots; every load of a thread is
//   issued before the first gather, and every gather before the first
//   product is stored, so a thread keeps its S slots (all its loads) in
//   flight. The products go to shared memory with the block's row
//   pointers (ptr[r0 .. r1] less the block's aligned start), then each row
//   is summed from shared memory by a group of G lanes, G the largest power
//   of two with G * rows <= kThreads (1 to 32): lane l sums entries
//   l, l + G, ... in four running sums, and the group meets in a
//   __shfl_down_sync butterfly.
// - A block of one row (a row past LONG_ROW, or one alone at a block's
//   edge): the CTA strides the row four strides at a time (four
//   independent gathers in flight a thread), meets in warp shuffles, and
//   thread 0 adds the kThreads / 32 warp sums in warp order.
// ind and val are read with the streaming hint (__ldcs: evict first), so
// the 33 MB that stream past on the webbase stand-in leave x (4 MB f32,
// 8 MB f64) in L2; x and the row pointers go through the read-only path.
// The order of every sum is fixed by the structure (no atomics), so a run
// repeats bit for bit; it is not index_add_'s order, so a comparison with
// the plain version (kernels/plain_spmv.py spmv_segsum) takes the dtype's
// model tolerance. The sums are kept in the value type, except bf16's:
// bf16 values and x sum in f32, and y is rounded to bf16 once.
//
// Instances (plain C entry points, bound with ctypes), each for int32 or
// int64 row pointers and int32 or int64 column indices:
//   spmv_csr_f32, spmv_csr_f64, spmv_csr_c64 (float2), spmv_csr_c128
//   (double2), spmv_csr_bf16 (val, x and y bf16, f32 sums)
// Each launches once on the given stream (nothing where the schedule has
// no block, m = 0), does not synchronise, allocates nothing, and returns
// cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a CTA
constexpr unsigned kFull = 0xffffffffu;

// bf16 values are stored as their 16 bits (unsigned short), and sum in f32
using Bf16Bits = unsigned short;

// the sum type of a stored value type E
template <typename E>
struct Sum {
  using type = E;
};
template <>
struct Sum<Bf16Bits> {
  using type = float;
};

// a stored value in its sum type, and a sum stored back (bf16: rounded to
// nearest even, once)
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float2 widen(float2 v) { return v; }
__device__ __forceinline__ double2 widen(double2 v) { return v; }
__device__ __forceinline__ float widen(Bf16Bits v) { return __uint_as_float(static_cast<unsigned>(v) << 16); }
template <typename E>
__device__ __forceinline__ void put(E* p, E v) {
  *p = v;
}
__device__ __forceinline__ void put(Bf16Bits* p, float v) { *p = __bfloat16_as_ushort(__float2bfloat16_rn(v)); }

// entries and rows a block of several rows holds at most (kernels/spmv_csr.py
// tile_of, which the schedule follows): 8 entries a thread for values of 4
// bytes or fewer, 4 for the wider types, whose slots hold more registers
// (scripts/csr_tiles.py times both on the card); shared memory holds the
// products and the row pointers
template <typename E>
struct Tile {
  static constexpr int entries = sizeof(E) > 4 ? 1024 : 2048;
  static constexpr int rows = entries / 2;
};

__device__ __forceinline__ float vzero(float) { return 0.0f; }
__device__ __forceinline__ double vzero(double) { return 0.0; }
__device__ __forceinline__ float2 vzero(float2) { return make_float2(0.0f, 0.0f); }
__device__ __forceinline__ double2 vzero(double2) { return make_double2(0.0, 0.0); }

__device__ __forceinline__ float vmad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double vmad(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float2 vmad(float2 a, float2 b, float2 c) {
  c.x = fmaf(a.x, b.x, c.x);
  c.x = fmaf(-a.y, b.y, c.x);
  c.y = fmaf(a.x, b.y, c.y);
  c.y = fmaf(a.y, b.x, c.y);
  return c;
}
__device__ __forceinline__ double2 vmad(double2 a, double2 b, double2 c) {
  c.x = fma(a.x, b.x, c.x);
  c.x = fma(-a.y, b.y, c.x);
  c.y = fma(a.x, b.y, c.y);
  c.y = fma(a.y, b.x, c.y);
  return c;
}

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ double vadd(double a, double b) { return a + b; }
__device__ __forceinline__ float2 vadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ double2 vadd(double2 a, double2 b) { return make_double2(a.x + b.x, a.y + b.y); }

__device__ __forceinline__ float vshfl(float v, int off, int w) { return __shfl_down_sync(kFull, v, off, w); }
__device__ __forceinline__ double vshfl(double v, int off, int w) { return __shfl_down_sync(kFull, v, off, w); }
__device__ __forceinline__ float2 vshfl(float2 v, int off, int w) {
  return make_float2(__shfl_down_sync(kFull, v.x, off, w), __shfl_down_sync(kFull, v.y, off, w));
}
__device__ __forceinline__ double2 vshfl(double2 v, int off, int w) {
  return make_double2(__shfl_down_sync(kFull, v.x, off, w), __shfl_down_sync(kFull, v.y, off, w));
}

// V elements of U moved as one 4-, 8- or 16-byte word
template <int N> struct RawOf;
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<16> { using type = uint4; };

template <typename U, int V>
union Pack {
  using Raw = typename RawOf<static_cast<int>(sizeof(U)) * V>::type;
  Raw raw;
  U e[V];
};

// entries a slot: 16 bytes of the wider of the index and value types
template <typename T, typename I>
struct SlotWidth {
  static constexpr int value = 16 / static_cast<int>(sizeof(T) > sizeof(I) ? sizeof(T) : sizeof(I));
};

// one row per CTA: four strides in flight a thread, then warp shuffles and
// the warp sums in warp order (part: kThreads / 32 values of shared memory)
template <typename E, typename I, typename T = typename Sum<E>::type>
__device__ __forceinline__ void long_row(const I* __restrict__ ind, const E* __restrict__ val,
                                         const E* __restrict__ x, E* __restrict__ y, long long row, long long s,
                                         long long e, T* part) {
  T a0 = vzero(T()), a1 = a0, a2 = a0, a3 = a0;
  long long p = s + threadIdx.x;
  for (; p + 3 * kThreads < e; p += 4 * kThreads) {
    const I c0 = __ldcs(ind + p), c1 = __ldcs(ind + p + kThreads);
    const I c2 = __ldcs(ind + p + 2 * kThreads), c3 = __ldcs(ind + p + 3 * kThreads);
    const T v0 = widen(__ldcs(val + p)), v1 = widen(__ldcs(val + p + kThreads));
    const T v2 = widen(__ldcs(val + p + 2 * kThreads)), v3 = widen(__ldcs(val + p + 3 * kThreads));
    a0 = vmad(v0, widen(__ldg(x + c0)), a0);
    a1 = vmad(v1, widen(__ldg(x + c1)), a1);
    a2 = vmad(v2, widen(__ldg(x + c2)), a2);
    a3 = vmad(v3, widen(__ldg(x + c3)), a3);
  }
  for (; p < e; p += kThreads) a0 = vmad(widen(__ldcs(val + p)), widen(__ldg(x + __ldcs(ind + p))), a0);
  T acc = vadd(vadd(a0, a1), vadd(a2, a3));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc = vadd(acc, vshfl(acc, off, 32));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T sum = part[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) sum = vadd(sum, part[w]);
    put(y + row, sum);
  }
}

template <typename E, typename P, typename I>
__global__ void __launch_bounds__(kThreads)
spmv_csr_blocks_kernel(const P* __restrict__ ptr, const I* __restrict__ ind, const E* __restrict__ val,
                       const E* __restrict__ x, E* __restrict__ y, const long long* __restrict__ blocks, int vec) {
  using T = typename Sum<E>::type;
  constexpr int V = SlotWidth<E, I>::value;
  constexpr int kTile = Tile<E>::entries, kMaxRows = Tile<E>::rows;
  constexpr int S = (kTile / V + 1 + kThreads - 1) / kThreads;  // slots a thread (the head adds one)
  constexpr int R = (kMaxRows + 1 + kThreads - 1) / kThreads;   // row pointers a thread
  __shared__ __align__(16) T prod[kTile + 4];
  __shared__ int rp[kMaxRows + 1];
  const int tid = threadIdx.x;
  const long long* blk = blocks + 2 * static_cast<long long>(blockIdx.x);
  const long long r0 = __ldg(blk), s = __ldg(blk + 1), r1 = __ldg(blk + 2), e = __ldg(blk + 3);
  const int nr = static_cast<int>(r1 - r0);
  if (nr == 1) {  // the same for the whole CTA
    long_row(ind, val, x, y, r0, s, e, prod);
    return;
  }
  // a schedule not made by csr_blocks would overrun the shared tiles
  if (nr > kMaxRows || e - s > kTile) __trap();
  const long long sa = s - s % V;  // the block's first slot boundary
  const int nslot = static_cast<int>((e - sa + V - 1) / V);

  // every load of ind, val and the row pointers, then every gather
  I c[S][V];
  T v[S][V];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = tid + k * kThreads;
    const long long p0 = sa + static_cast<long long>(j) * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      c[k][i] = 0;
      v[k][i] = vzero(T());
    }
    if (j < nslot) {
      if (vec && p0 >= s && p0 + V <= e) {
        Pack<I, V> pc;
        Pack<E, V> pv;
        pc.raw = __ldcs(reinterpret_cast<const typename Pack<I, V>::Raw*>(ind + p0));
        pv.raw = __ldcs(reinterpret_cast<const typename Pack<E, V>::Raw*>(val + p0));
#pragma unroll
        for (int i = 0; i < V; ++i) {
          c[k][i] = pc.e[i];
          v[k][i] = widen(pv.e[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (p0 + i >= s && p0 + i < e) {
            c[k][i] = __ldcs(ind + p0 + i);
            v[k][i] = widen(__ldcs(val + p0 + i));
          }
        }
      }
    }
  }
  P pr[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = tid + k * kThreads;
    pr[k] = i <= nr ? __ldg(ptr + r0 + i) : P(0);
  }
  T xv[S][V];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const long long p0 = sa + static_cast<long long>(tid + k * kThreads) * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      xv[k][i] = (p0 + i >= s && p0 + i < e) ? widen(__ldg(x + c[k][i])) : vzero(T());
    }
  }
  // the products (a zero where a slot's entry lies outside the block; no
  // row reads it) and the row pointers relative to sa
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = tid + k * kThreads;
    if (j < nslot) {
      Pack<T, V> pp;
#pragma unroll
      for (int i = 0; i < V; ++i) pp.e[i] = vmad(v[k][i], xv[k][i], vzero(T()));
      *reinterpret_cast<typename Pack<T, V>::Raw*>(prod + j * V) = pp.raw;
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = tid + k * kThreads;
    if (i <= nr) rp[i] = static_cast<int>(static_cast<long long>(pr[k]) - sa);
  }
  __syncthreads();

  // G lanes a row; every lane of the CTA takes the same number of passes,
  // so each warp reaches the butterfly whole
  const int G = nr >= kThreads ? 1 : min(32, 1 << (31 - __clz(kThreads / nr)));
  const int per = kThreads / G;
  const int grp = tid / G, lane = tid & (G - 1);
  for (int base = 0; base < nr; base += per) {
    const int r = base + grp;
    T acc = vzero(T());
    if (r < nr) {
      T a0 = acc, a1 = acc, a2 = acc, a3 = acc;
      const int qe = rp[r + 1];
      int q = rp[r] + lane;
      for (; q + 3 * G < qe; q += 4 * G) {
        a0 = vadd(a0, prod[q]);
        a1 = vadd(a1, prod[q + G]);
        a2 = vadd(a2, prod[q + 2 * G]);
        a3 = vadd(a3, prod[q + 3 * G]);
      }
      for (; q < qe; q += G) a0 = vadd(a0, prod[q]);
      acc = vadd(vadd(a0, a1), vadd(a2, a3));
    }
    for (int off = G / 2; off > 0; off >>= 1) acc = vadd(acc, vshfl(acc, off, G));
    if (lane == 0 && r < nr) put(y + r0 + r, acc);
  }
}

template <typename E, typename P, typename I>
int launch(const void* ptr, const void* ind, const void* val, const void* x, void* y, const void* blocks,
           long long nblk, void* stream) {
  if (nblk <= 0) return static_cast<int>(cudaSuccess);
  // 16-byte loads of a slot need both streams 16-byte aligned (a tensor
  // from PyTorch's allocator is; a view at an offset may not be)
  const int vec = ((reinterpret_cast<uintptr_t>(ind) | reinterpret_cast<uintptr_t>(val)) & 15u) == 0;
  spmv_csr_blocks_kernel<E, P, I><<<static_cast<unsigned>(nblk), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const P*>(ptr), static_cast<const I*>(ind), static_cast<const E*>(val), static_cast<const E*>(x),
      static_cast<E*>(y), static_cast<const long long*>(blocks), vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int dispatch(const void* ptr, const void* ind, const void* val, const void* x, void* y, const void* blocks,
             long long nblk, int ptr64, int ind64, void* stream) {
  if (ptr64) {
    return ind64 ? launch<E, long long, long long>(ptr, ind, val, x, y, blocks, nblk, stream)
                 : launch<E, long long, int>(ptr, ind, val, x, y, blocks, nblk, stream);
  }
  return ind64 ? launch<E, int, long long>(ptr, ind, val, x, y, blocks, nblk, stream)
               : launch<E, int, int>(ptr, ind, val, x, y, blocks, nblk, stream);
}

}  // namespace

extern "C" {

// ptr (m + 1) and ind (nnz) int32 or int64 (ptr64, ind64), val (nnz) and
// x (n) of the instance's type, y (m) written; blocks: the schedule,
// (nblk + 1) x 2 int64 (first row, first entry) pairs, the last (m, ptr[m])
int spmv_csr_f32(const void* ptr, const void* ind, const void* val, const void* x, void* y, const void* blocks,
                 int64_t nblk, int ptr64, int ind64, void* stream) {
  return dispatch<float>(ptr, ind, val, x, y, blocks, nblk, ptr64, ind64, stream);
}

int spmv_csr_f64(const void* ptr, const void* ind, const void* val, const void* x, void* y, const void* blocks,
                 int64_t nblk, int ptr64, int ind64, void* stream) {
  return dispatch<double>(ptr, ind, val, x, y, blocks, nblk, ptr64, ind64, stream);
}

int spmv_csr_c64(const void* ptr, const void* ind, const void* val, const void* x, void* y, const void* blocks,
                 int64_t nblk, int ptr64, int ind64, void* stream) {
  return dispatch<float2>(ptr, ind, val, x, y, blocks, nblk, ptr64, ind64, stream);
}

int spmv_csr_c128(const void* ptr, const void* ind, const void* val, const void* x, void* y, const void* blocks,
                  int64_t nblk, int ptr64, int ind64, void* stream) {
  return dispatch<double2>(ptr, ind, val, x, y, blocks, nblk, ptr64, ind64, stream);
}

// val, x and y bf16 (their 16 bits), f32 sums, y rounded once
int spmv_csr_bf16(const void* ptr, const void* ind, const void* val, const void* x, void* y, const void* blocks,
                  int64_t nblk, int ptr64, int ind64, void* stream) {
  return dispatch<Bf16Bits>(ptr, ind, val, x, y, blocks, nblk, ptr64, ind64, stream);
}

}  // extern "C"
