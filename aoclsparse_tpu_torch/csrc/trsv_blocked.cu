// Blocked triangular solve chain for NVIDIA Hopper (sm_90a): the solve of
// the planner's `dwin` (diagonal window) and `gather` (padded-ELL) TrsvForms
// with pre-inverted diagonal blocks, with K right-hand sides (K = 1 for
// trsv). For the row blocks k = 0..nblk-1 of nb rows, in order, blk0 = k*nb:
//
//   dwin:    s_k[r] = sum_d Dv[k, d, r] * x[blk0 - off_d + r]     (r < off_d)
//   gather:  s_k[r] = sum_{w < cnt[k, r]} Lval[k, r, w] * x[Lind[k, r, w]]
//   then     x_k = Dinv_k (b_k - s_k)
//
// over dinvT (nblk, nb, nb), dinvT[k] = Dinv_k^T, the inverted lower
// triangular diagonal blocks transposed; Dv (nblk, ndg, nb) with the ndg
// ascending offsets off_d (int32); or Lval (nblk, nb, W), Lind (nblk, nb, W)
// int32 and cnt (nblk, nb) int32, each row's count of stored left entries
// (they fill its first cnt slots; the rest of a row is padding, value 0 and
// index 0); row-major B, X of (nblk*nb, K). A dwin term reads x only left of
// the block and at rows >= 0: its other slots (off_d <= r, an entry inside
// the diagonal block, or a row before 0) hold Dv == 0 and read the zero pad
// or the zero window in the JAX scan, 0 * 0, which the kernel leaves out
// with the same result. A gather row's padding slots are never read: the
// scan multiplies them, 0 * x[0], which differs only where solved x[0] is
// Inf or NaN (ROADMAP.md queue 3). Every stored slot is multiplied as
// stored, a zero value included.
//
// Stands for the JAX package's XLA scans (no Pallas kernel there):
//   aoclsparse_tpu/kernels/xla/trsv.py:103  trsv_blocked_dwin (inv=True)
//   aoclsparse_tpu/kernels/xla/trsv.py:152  trsv_blocked (the inverted-block twin)
// the `inv=True` branch the JAX package takes on its accelerator
// (planner/triangular.py:211-226 there); the port's `win` solve takes it too.
//
// What bounds it: block k depends on the blocks before it, so the solve is
// a chain of nblk dependent steps, and its bytes (dinvT's triangles, the
// left operand, b and x once) are far below what the step latency costs.
// The first design (one CTA of 1,024 threads walking all blocks, four CTA
// barriers a step, solved x and the inverted triangle read back from L2 each
// step) took 2.4-2.5 us a step, 5.2 on scircuit's 120-slot padded rows. This
// design takes off a step's dependent path everything that does not depend
// on the step before it:
//
// - A thread-block cluster a chunk of KC columns (1, 2 or 4; the chunks'
//   clusters run side by side): CTA 0 is the chain, CTAs 1..H the helpers.
// - A left entry is near when its source block is less than D blocks back,
//   far otherwise. The helpers take the far sums off the chain: a helper
//   group (nb threads, one a row; S groups a CTA) takes the blocks j = g,
//   g + H*S, ..., waits until the chain has solved block j - D (a shared
//   word the chain's publisher warp stores into every helper), sums row r's
//   far terms over solved x (read from L2), and delivers b - far and row
//   r's near entries (value, and the source row's place in the chain's ring
//   of solved x; at most NR a row, else the row is marked for the chain to
//   scan itself) into the chain CTA's shared memory, slot j mod D, by
//   st.async, which completes the slot's mbarrier (armed by the chain for a
//   fixed byte count when it frees the slot after step j - D).
// - The chain CTA keeps the x of its last D blocks in a shared ring and
//   runs S slices of nb threads (one a row). Step k: slice 0 sums a row's
//   near entries over the ring, rhs = (b - far) - near; a named barrier;
//   every slice takes its share of the triangle product, the batches b =
//   s, s + S, ... of 8 / KC rows of x_r = sum over q <= r of dinvT[k][q][r]
//   rhs[q] (dinvT's upper triangle only; NACC accumulators, the batch's rhs
//   in 16-byte loads); a named barrier; slice 0 adds the partials in slice
//   order, rounds x to the operand dtype and stores it to the ring and to X;
//   a named barrier of slice 0 and one warp of slice 1, whose first thread
//   re-arms the slot and publishes the progress.
// - A loader warp of the chain CTA issues dinvT's block j by TMA
//   (cp.async.bulk into a ring of P stages) once the chain has freed its
//   stage (finished step j - P), waits on the stage's and the delivery
//   slot's mbarriers, and publishes a ready count; slice 0 reads it with
//   one acquire for every block it clears. A publisher warp turns the
//   chain's progress into one cluster-scope fence and a store into each
//   helper's shared memory. Waits that never end trap (the launch fails)
//   rather than hang the card.
// So a step touches only shared memory. Measured on the card (PERF.md §6,
// scripts/chain_bench.py): the step is latency-bound at about 1 us, most of
// it a few dependent shared-memory round trips and barriers in warps that
// have nothing to overlap them with; the triangle product, the one part
// that grows with nb, shrinks with the slices, and nb = 128 (CHAIN_NB)
// halves the steps at a small cost a step.
//
// Every sum runs in a fixed order, with no atomics: the far sum of a row in
// entry order, the near sum in entry order, the triangle product over the
// slices and NACC = 4 / KC accumulators as above; the same inputs give the
// same bits, whatever the helpers' timing (tests/test_torch_chain_redesign.py
// emulates the order). The order differs from the scan's, within the dtype's
// model tolerance. Rows of dinvT_k below its diagonal are never read: a
// non-finite rhs value in row q of a block leaves the block's rows r < q as
// a triangular solve gives them, where the scan's dense product (0 * Inf)
// gives NaN.
//
// Instances: f32, f64; bf16 (bf16 operands, f32 sums, x rounded to bf16 as
// each block is solved, as the window solves' bf16 instance; b - far, the
// near values and the chain's rhs stay f32); complex64 and complex128
// (complex multiply-adds on float2 / double2, as the level kernel's). Shared
// memory is sized at launch: the ring, the D delivery slots and as many
// dinvT stages (P <= 4) as fit in 227 KB (P = 0: the triangle is read from
// L2, for a block whose size TMA cannot copy or that does not fit); D
// shrinks where two stages would not fit. nb <= 256. Every CTA of a launch
// gets the same dynamic shared memory, so each helper holds the chain's
// full size, of which it uses only the progress word: a cluster of H + 1 =
// 8 CTAs takes 8 SMs of one GPC, and the column chunks of a wide B run in
// waves once 8 * K / KC passes the card's 132 SMs.
//
// Plain C entry points, bound with ctypes:
//   trsv_blocked_{f32,f64,bf16,c64,c128}(mode, dinvT, Lv, aux, cnt, B, X,
//     nblk, nb, nw, K, KC, stream, launches)
// mode 0 = dwin (aux = the ndg offsets, cnt unused), 1 = gather (aux =
// Lind). Each launches one kernel (cudaLaunchKernelEx with a cluster
// dimension) on the given stream, does not synchronise, allocates nothing,
// adds 1 to *launches, and returns the first CUDA error of the attribute
// calls or the launch (0 on success; cudaErrorInvalidValue for arguments
// out of range). trsv_blocked_layout reports the launch shape an instance
// would take.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxNb = 256;
constexpr int kMaxThreads = 512;
// the ring depth and the helper CTAs of a cluster (PERF.md §6: D = 2, 8, 16
// and H = 1, 7 measured, these kept)
constexpr int kRingD = 8;
constexpr int kHelpers = 7;
constexpr int kMaxStages = 4;
// slices of a chain row's triangle product (a row's partials meet in slice order)
constexpr int kMaxSlices = 4;
// near entries a row in a delivery slot
constexpr int kNearRow = 4;
// a dwin helper row asks L1 for its first kPrefetch diagonals before it waits
constexpr int kPrefetch = 16;
constexpr size_t kSmemBudget = 232448;
// polls of a wait before it traps: seconds, far past any step
constexpr uint32_t kMaxPolls = 1u << 26;
// the pause between polls of a waiting helper, publisher or loader
constexpr unsigned kBackoffNs = 64;

enum Mode { kDwin = 0, kGather = 1 };

// ---- the value arithmetic: T the stored dtype, A the sums' -------------
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float2 widen(float2 v) { return v; }
__device__ __forceinline__ double2 widen(double2 v) { return v; }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <typename T>
__device__ __forceinline__ T narrow(double v) { return v; }
template <typename T>
__device__ __forceinline__ T narrow(float2 v) { return v; }
template <typename T>
__device__ __forceinline__ T narrow(double2 v) { return v; }

__device__ __forceinline__ float mad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mad(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float2 mad(float2 a, float2 b, float2 c) {
  return make_float2(fmaf(a.x, b.x, fmaf(-a.y, b.y, c.x)), fmaf(a.x, b.y, fmaf(a.y, b.x, c.y)));
}
__device__ __forceinline__ double2 mad(double2 a, double2 b, double2 c) {
  return make_double2(fma(a.x, b.x, fma(-a.y, b.y, c.x)), fma(a.x, b.y, fma(a.y, b.x, c.y)));
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ double add(double a, double b) { return a + b; }
__device__ __forceinline__ float2 add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ double2 add(double2 a, double2 b) { return make_double2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float sub(float a, float b) { return a - b; }
__device__ __forceinline__ double sub(double a, double b) { return a - b; }
__device__ __forceinline__ float2 sub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ double2 sub(double2 a, double2 b) { return make_double2(a.x - b.x, a.y - b.y); }
template <typename A>
__device__ __forceinline__ A zero() { return A(0); }
template <>
__device__ __forceinline__ float2 zero<float2>() { return make_float2(0.f, 0.f); }
template <>
__device__ __forceinline__ double2 zero<double2>() { return make_double2(0.0, 0.0); }

// solved x read by a helper: from L2 (ld.global.cg), never a stale L1 line
__device__ __forceinline__ float load_x(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double load_x(const double* p) { return __ldcg(p); }
__device__ __forceinline__ float2 load_x(const float2* p) { return __ldcg(p); }
__device__ __forceinline__ double2 load_x(const double2* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 load_x(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// ---- shared memory, barriers, TMA ---------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}
__device__ __forceinline__ int ld_acquire_cluster(const int* p) {
  int v;
  asm volatile("ld.acquire.cluster.shared::cta.u32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}
// wait until the shared word *p (stored with release by another CTA of the
// cluster) reaches `want`; a wait that never ends traps (the launch fails)
// rather than hang the card
__device__ __forceinline__ void spin_until(const int* p, int want) {
  for (uint32_t polls = 0; ld_acquire_cluster(p) < want;) {
    if (++polls == kMaxPolls) __trap();
    __nanosleep(kBackoffNs);
  }
}
__device__ __forceinline__ int ld_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared::cta.u32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}
__device__ __forceinline__ void st_release_cta(int* p, int v) {
  asm volatile("st.release.cta.shared::cta.u32 [%0], %1;" ::"r"(smem_addr(p)), "r"(v) : "memory");
}
__device__ __forceinline__ void st_relaxed_cluster(uint32_t a, int v) {
  asm volatile("st.relaxed.cluster.shared::cluster.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void fence_cluster() { asm volatile("fence.acq_rel.cluster;" ::: "memory"); }
__device__ __forceinline__ void named_sync(int id, int count) {
  if (count == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void prefetch_l1(const void* p) { asm volatile("prefetch.global.L1 [%0];" ::"l"(p)); }

// an asynchronous store into the shared memory of another CTA of the
// cluster (a shared::cluster address), completing its bytes on that CTA's
// mbarrier `bar`
__device__ __forceinline__ void st_async(uint32_t a, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];" ::"r"(a), "f"(v), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void st_async(uint32_t a, double v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [%0], %1, [%2];" ::"r"(a), "d"(v), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void st_async(uint32_t a, float2 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];" ::"r"(a),
               "f"(v.x), "f"(v.y), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void st_async(uint32_t a, double2 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f64 [%0], {%1, %2}, [%3];" ::"r"(a),
               "d"(v.x), "d"(v.y), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void st_async(uint32_t a, int v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(a), "r"(v), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arm(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == kMaxPolls) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// one TMA bulk copy of `bytes` (a multiple of 16, both ends 16-aligned)
// completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// ---- the launch shape, and where each buffer lies in shared memory --------
struct Layout {
  int D, H, Q, P, NR, rp, threads;
  uint32_t o_bar, o_sbar, o_prog, o_pub, o_ready, o_dinv, o_red, o_rhs, o_ring, o_rhs0, o_ncnt, o_nval, o_npos, total;
  // bytes a helper delivers into a slot: b - far, the near counts and NR
  // near entries (value in the sums' dtype, ring place) a row
  uint32_t slot_bytes;
};

template <typename T>
struct Args {
  const T* dinvT;
  const T* Lv;
  const int32_t* aux;
  const int32_t* cnt;
  const T* B;
  T* X;
  int nblk, nb, nw, K;
};

inline uint32_t align16(size_t v) { return static_cast<uint32_t>((v + 15) / 16 * 16); }

// the launch shape for nb rows, KC columns, element sizes te (stored) and
// ta (sums), ring depth kRingD and kHelpers helper CTAs: the most dinvT
// stages (<= kMaxStages) that fit, D halved while not even one stage or the
// ring fits, P = 0 where the block cannot go by TMA or does not fit
Layout plan_layout(int nb, int KC, size_t te, size_t ta) {
  Layout L{};
  L.rp = (nb + 31) / 32 * 32;
  // S slices of the chain's rows (and S helper groups a CTA), two more
  // warps: the publisher and the loader
  L.Q = std::max(1, std::min(kMaxSlices, (kMaxThreads - 64) / L.rp));
  L.threads = L.rp * L.Q + 64;
  L.H = kHelpers;
  L.NR = kNearRow;
  const size_t blk = static_cast<size_t>(nb) * nb * te;
  const bool tma_ok = blk % 16 == 0 && blk < (1u << 20);
  // the buffers of ring depth d, and the stages that fit beside them
  auto place = [&](int d) {
    L.D = d;
    uint32_t o = 0;
    L.o_bar = o;
    o += 8 * kMaxStages;
    L.o_sbar = o;
    o = align16(o + 8 * static_cast<size_t>(d));
    L.o_prog = o;
    o += 16;
    L.o_pub = o;
    o += 16;
    L.o_ready = o;
    o += 16;
    L.o_red = o;
    o = align16(o + ta * static_cast<size_t>(L.Q - 1) * nb * KC);
    L.o_rhs = o;
    // the rhs and the slot of the last batch may be read past nb rows
    o = align16(o + ta * (nb + 8) * KC);
    L.o_ring = o;
    o = align16(o + te * d * nb * KC);
    L.o_rhs0 = o;
    o = align16(o + ta * d * nb * KC);
    L.o_ncnt = o;
    o = align16(o + 4 * static_cast<size_t>(d) * nb);
    L.o_nval = o;
    o = align16(o + ta * d * L.NR * nb);
    L.o_npos = o;
    o = align16(o + 4 * static_cast<size_t>(d) * L.NR * nb);
    L.slot_bytes = static_cast<uint32_t>(nb * (KC * ta + 4 + L.NR * (ta + 4)));
    L.o_dinv = o;
    const size_t room = o <= kSmemBudget ? kSmemBudget - o : 0;
    L.P = tma_ok ? static_cast<int>(std::min<size_t>(kMaxStages, room / blk)) : 0;
    L.total = o + static_cast<uint32_t>(L.P * blk);
  };
  // kRingD where two or more stages fit beside it; else the
  // largest smaller D (down to 2) where they do; else the largest D that
  // fits with what stages remain (1 or 0: the triangle read from L2)
  for (int d = kRingD; d >= 2; d = d / 2) {
    place(d);
    if (L.P >= 2 && L.total <= kSmemBudget) return L;
  }
  for (int d = kRingD; d >= 1; d = d > 2 ? d / 2 : d - 1) {
    place(d);
    if (L.total <= kSmemBudget) return L;
  }
  return L;
}

// the left entries of row r of block j, in entry order: fn(src row, value);
// U unrolls a gather row's loop (1 for the chain's rare scan: a small step)
template <typename T, int MODE, int U, typename F>
__device__ __forceinline__ void for_entries(const Args<T>& g, int j, int r, F&& fn) {
  const int nb = g.nb;
  const int64_t blk0 = static_cast<int64_t>(j) * nb;
  if (MODE == kDwin) {
    const T* dv = g.Lv + static_cast<int64_t>(j) * g.nw * nb + r;
#pragma unroll 1
    for (int d = 0; d < g.nw; ++d) {
      const int off = g.aux[d];
      const int64_t src = blk0 - off + r;
      if (r < off && src >= 0) fn(src, dv[static_cast<int64_t>(d) * nb]);
    }
  } else {
    const int64_t base = (blk0 + r) * g.nw;
    const int n = g.cnt[blk0 + r];
#pragma unroll U
    for (int w = 0; w < n; ++w) fn(static_cast<int64_t>(g.aux[base + w]), g.Lv[base + w]);
  }
}

// ---- the kernel -----------------------------------------------------------
template <typename T, typename A, int MODE, int KC>
__global__ void __launch_bounds__(kMaxThreads, 1) trsv_blocked_kernel(const Args<T> g, const Layout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = L.H + 1;
  const int col0 = static_cast<int>(blockIdx.x / C) * KC;
  const int kc = min(KC, g.K - col0);
  const int nb = g.nb, D = L.D, NR = L.NR, rp = L.rp;
  const int t = threadIdx.x;
  constexpr int NACC = 4 / KC;
  constexpr int QB = 8 / KC;
  constexpr int kRv = static_cast<int>(QB * KC * sizeof(A) / 16);

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.o_bar);
  uint64_t* sbar = reinterpret_cast<uint64_t*>(smem + L.o_sbar);
  int* prog = reinterpret_cast<int*>(smem + L.o_prog);
  int* pub = reinterpret_cast<int*>(smem + L.o_pub);
  int* ready = reinterpret_cast<int*>(smem + L.o_ready);
  T* dinv = reinterpret_cast<T*>(smem + L.o_dinv);
  A* rhs = reinterpret_cast<A*>(smem + L.o_rhs);
  A* red = reinterpret_cast<A*>(smem + L.o_red);
  const int S = L.Q;
  T* ring = reinterpret_cast<T*>(smem + L.o_ring);
  A* rhs0 = reinterpret_cast<A*>(smem + L.o_rhs0);
  int* ncnt = reinterpret_cast<int*>(smem + L.o_ncnt);
  A* nval = reinterpret_cast<A*>(smem + L.o_nval);
  int* npos = reinterpret_cast<int*>(smem + L.o_npos);

  if (t == 0) {
    *prog = 0;
    *pub = 0;
    *ready = 0;
    if (rank == 0) {
      for (int s = 0; s < L.P; ++s) mbar_init(bar + s);
      // each delivery slot's barrier, armed for its first delivery
      for (int s = 0; s < D; ++s) {
        mbar_init(sbar + s);
        mbar_arm(sbar + s, L.slot_bytes);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();

  if (rank == 0) {
    if (t < S * rp) {
      // the chain: thread t owns row r of slice sl; slice 0 also sums the
      // row's near terms and finishes x
      const int sl = t / rp;
      const int r = t - sl * rp;
      const bool row = r < nb;
      // slice sl's part of x_r = sum over q <= r of dk[q][r] rhs[q] (dk:
      // the stage in shared memory, or dinvT's block in device memory):
      // the batches b = sl, sl + S, ... of QB rows, every load of a batch in
      // flight before its multiply-adds, accumulator q mod NACC, added as
      // (a0 + a1) + (a2 + a3)
      auto partial = [&](const T* dk, A (&p)[KC]) {
        A a[NACC][KC];
#pragma unroll
        for (int u = 0; u < NACC; ++u)
#pragma unroll
          for (int c = 0; c < KC; ++c) a[u][c] = zero<A>();
        const int qend = r + 1;
        const T* dkr = dk + r;
#pragma unroll 1
        for (int q = sl * QB; q < qend; q += S * QB) {
          if (q + QB <= qend) {
            // the batch's QB x KC rhs values (8 of A: 32-128 bytes) in
            // 16-byte loads, the same for every lane
            union {
              uint4 u[kRv];
              A v[QB * KC];
            } rb;
            const uint4* r4 = reinterpret_cast<const uint4*>(rhs + q * KC);
#pragma unroll
            for (int i = 0; i < kRv; ++i) rb.u[i] = r4[i];
            A dv[QB];
#pragma unroll
            for (int i = 0; i < QB; ++i) dv[i] = widen(dkr[(q + i) * nb]);
#pragma unroll
            for (int i = 0; i < QB; ++i)
#pragma unroll
              for (int c = 0; c < KC; ++c) a[i % NACC][c] = mad(dv[i], rb.v[i * KC + c], a[i % NACC][c]);
          } else {
#pragma unroll
            for (int i = 0; i < QB; ++i)
              if (q + i < qend) {
                const A v = widen(dkr[(q + i) * nb]);
#pragma unroll
                for (int c = 0; c < KC; ++c) a[i % NACC][c] = mad(v, rhs[(q + i) * KC + c], a[i % NACC][c]);
              }
          }
        }
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          if constexpr (NACC == 4)
            p[c] = add(add(a[0][c], a[1][c]), add(a[2][c], a[3][c]));
          else if constexpr (NACC == 2)
            p[c] = add(a[0][c], a[1][c]);
          else
            p[c] = a[0][c];
        }
      };
      int slot = 0, st = 0, seen = 0;
      for (int k = 0; k < g.nblk; ++k) {
        const int64_t blk0 = static_cast<int64_t>(k) * nb;
        if (sl == 0) {
          // the loader warp has seen block k's delivery and dinvT stage
          // land: one acquire covers every block it has cleared so far
          for (uint32_t polls = 0; k >= seen;) {
            seen = ld_acquire_cta(ready);
            if (++polls == kMaxPolls) __trap();
          }
          if (row) {
            A s_[KC];
#pragma unroll
            for (int c = 0; c < KC; ++c) s_[c] = zero<A>();
            const int n = ncnt[slot * nb + r];
            if (n >= 0) {
              for (int i = 0; i < n; ++i) {
                const A v = nval[(slot * NR + i) * nb + r];
                const T* xr = ring + npos[(slot * NR + i) * nb + r] * KC;
#pragma unroll
                for (int c = 0; c < KC; ++c) s_[c] = mad(v, widen(xr[c]), s_[c]);
              }
            } else {
              // more near entries than a slot holds: scan the row here
              const int64_t near_lo = static_cast<int64_t>(k - D + 1) * nb;
              for_entries<T, MODE, 1>(g, k, r, [&](int64_t src, T v) {
                if (src >= near_lo) {
                  const int64_t sb = src / nb;
                  const T* xr = ring + ((sb % D) * nb + (src - sb * nb)) * KC;
#pragma unroll
                  for (int c = 0; c < KC; ++c) s_[c] = mad(widen(v), widen(xr[c]), s_[c]);
                }
              });
            }
#pragma unroll
            for (int c = 0; c < KC; ++c) rhs[r * KC + c] = sub(rhs0[(slot * nb + r) * KC + c], s_[c]);
          }
        }
        named_sync(1, S * rp);
        A p[KC];
        if (row) {
          // two calls, so that the staged one reads shared memory directly
          if (L.P > 0)
            partial(dinv + st * nb * nb, p);
          else
            partial(g.dinvT + blk0 * nb, p);
        }
        if (S > 1) {
          if (sl > 0 && row)
#pragma unroll
            for (int c = 0; c < KC; ++c) red[((sl - 1) * nb + r) * KC + c] = p[c];
          named_sync(2, S * rp);
        }
        if (sl == 0) {
          if (row) {
            // x in slice order, rounded to the stored dtype; to the ring
            // slot and to X
            T* xo = ring + (slot * nb + r) * KC;
#pragma unroll
            for (int c = 0; c < KC; ++c) {
              A x = p[c];
              for (int u = 1; u < S; ++u) x = add(x, red[((u - 1) * nb + r) * KC + c]);
              const T xt = narrow<T>(x);
              xo[c] = xt;
              if (c < kc) g.X[(blk0 + r) * g.K + col0 + c] = xt;
            }
          }
        }
        // slice 0 has read slot k and written x_k: slot k mod D is free,
        // armed for block k + D, then the progress (by the first thread of
        // slice 1 where there is one: off slice 0's path into step k + 1)
        const int tw = S > 1 ? rp : 0;
        if (sl == 0 || t < tw + 32) named_sync(3, S > 1 ? rp + 32 : rp);
        if (t == tw) {
          if (k + D < g.nblk) mbar_arm(sbar + slot, L.slot_bytes);
          st_release_cta(pub, k + 1);
        }
        slot = slot + 1 == D ? 0 : slot + 1;
        if (L.P > 0) st = st + 1 == L.P ? 0 : st + 1;
      }
    } else if (t / 32 == S * rp / 32) {
      // the publisher warp: the chain's progress to every helper's shared
      // word (lane 0 stores; the warp polls together)
      int last = 0;
      uint32_t polls = 0;
      while (last < g.nblk) {
        int v = (t & 31) == 0 ? (ld_acquire_cta(pub)) : 0;
        v = __shfl_sync(0xffffffffu, v, 0);
        if (v == last) {
          if (++polls == kMaxPolls) __trap();
          __nanosleep(kBackoffNs);
          continue;
        }
        last = v;
        polls = 0;
        if ((t & 31) == 0) {
          fence_cluster();
          for (int h = 1; h <= L.H; ++h) st_relaxed_cluster(cluster_addr(prog, h), v);
        }
      }
    } else if (t / 32 == S * rp / 32 + 1) {
      // the loader warp: dinvT's block j into stage j mod P by TMA once the
      // chain has freed it (finished step j - P), and the chain's go-ahead:
      // ready = k + 1 once block k's stage and delivery slot have landed
      // (the mbarrier waits stay off the chain's path)
      const uint32_t blk_bytes = static_cast<uint32_t>(static_cast<size_t>(nb) * nb * sizeof(T));
      const bool lead = (t & 31) == 0;
      int issued = 0;
      auto issue = [&]() {
        if (lead) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          tma_load(dinv + static_cast<size_t>(issued % L.P) * nb * nb, g.dinvT + static_cast<int64_t>(issued) * nb * nb,
                   blk_bytes, bar + issued % L.P);
        }
        ++issued;
      };
      for (int k = 0; k < g.nblk; ++k) {
        if (L.P > 0) {
          // step k's stage: issued once the chain has finished step k - P
          for (; issued <= k; issue())
            for (uint32_t polls = 0; issued >= L.P && (ld_acquire_cta(pub)) < issued - L.P + 1;) {
              if (++polls == kMaxPolls) __trap();
              __nanosleep(kBackoffNs);
            }
          // and every later one whose stage the chain has freed, unwaited
          int v = lead ? (ld_acquire_cta(pub)) : 0;
          v = __shfl_sync(0xffffffffu, v, 0);
          while (issued < g.nblk && issued - L.P + 1 <= v) issue();
          mbar_wait(bar + k % L.P, (k / L.P) & 1);
        }
        mbar_wait(sbar + k % D, (k / D) & 1);
        if (lead) st_release_cta(ready, k + 1);
      }
    }
  } else {
    // a helper: group q of this CTA, thread r of the group owns row r
    const int q = min(t / rp, L.Q);
    const int r = t - q * rp;
    const bool row = r < nb && q < L.Q;
    const int HG = L.H * L.Q;
    // the chain CTA's delivery slots, as shared::cluster addresses
    const uint32_t c_rhs0 = cluster_addr(rhs0, 0), c_ncnt = cluster_addr(ncnt, 0);
    const uint32_t c_nval = cluster_addr(nval, 0), c_npos = cluster_addr(npos, 0);
    const uint32_t c_sbar = cluster_addr(sbar, 0);
    for (int j = (rank - 1) * L.Q + q; q < L.Q && j < g.nblk; j += HG) {
      const int slot = j % D;
      const int64_t blk0 = static_cast<int64_t>(j) * nb;
      A bv[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) bv[c] = zero<A>();
      if (row) {
#pragma unroll
        for (int c = 0; c < KC; ++c)
          if (c < kc) bv[c] = widen(g.B[(blk0 + r) * g.K + col0 + c]);
        // the row's operands do not depend on x: ask L1 for them first
        if (MODE == kDwin) {
          for (int d = 0; d < min(g.nw, kPrefetch); ++d)
            prefetch_l1(g.Lv + (static_cast<int64_t>(j) * g.nw + d) * nb + r);
        } else {
          const int64_t base = (blk0 + r) * g.nw;
          const int n = g.cnt[blk0 + r];
          if (n > 0) {
            prefetch_l1(g.aux + base);
            prefetch_l1(g.Lv + base);
            prefetch_l1(g.aux + base + n - 1);
            prefetch_l1(g.Lv + base + n - 1);
          }
        }
      }
      const int need = j - D + 1;
      if (need > 0) spin_until(prog, need);
      if (row) {
        const int64_t near_lo = static_cast<int64_t>(need) * nb;
        A far[KC];
#pragma unroll
        for (int c = 0; c < KC; ++c) far[c] = zero<A>();
        int nn = 0;
        const uint32_t sb = c_sbar + 8 * slot;
        for_entries<T, MODE, 4>(g, j, r, [&](int64_t src, T v) {
          if (src < near_lo) {
            const T* xr = g.X + src * g.K + col0;
#pragma unroll
            for (int c = 0; c < KC; ++c)
              if (c < kc) far[c] = mad(widen(v), widen(load_x(xr + c)), far[c]);
          } else {
            if (nn < NR) {
              const int64_t sbk = src / nb;
              const uint32_t e = static_cast<uint32_t>((slot * NR + nn) * nb + r);
              st_async(c_nval + e * static_cast<uint32_t>(sizeof(A)), widen(v), sb);
              st_async(c_npos + 4 * e, static_cast<int>((sbk % D) * nb + (src - sbk * nb)), sb);
            }
            ++nn;
          }
        });
        // the slot's bytes are fixed: the unused near places too
        for (int i = nn; i < NR; ++i) {
          const uint32_t e = static_cast<uint32_t>((slot * NR + i) * nb + r);
          st_async(c_nval + e * static_cast<uint32_t>(sizeof(A)), zero<A>(), sb);
          st_async(c_npos + 4 * e, 0, sb);
        }
#pragma unroll
        for (int c = 0; c < KC; ++c)
          st_async(c_rhs0 + static_cast<uint32_t>(((slot * nb + r) * KC + c) * sizeof(A)), sub(bv[c], far[c]), sb);
        st_async(c_ncnt + 4 * static_cast<uint32_t>(slot * nb + r), nn <= NR ? nn : -1, sb);
      }
    }
  }
  // no CTA leaves while another may still touch its shared memory
  cluster.sync();
}

template <typename T, typename A, int MODE, int KC>
int launch_kc(const Args<T>& a, const Layout& L, int nchunks, cudaStream_t stream) {
  auto kern = trsv_blocked_kernel<T, A, MODE, KC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (L.H + 1 > 8) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nchunks * (L.H + 1)), 1, 1);
  cfg.blockDim = dim3(static_cast<unsigned>(L.threads), 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(L.H + 1);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a, L);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int launch(int64_t mode, const void* dinvT, const void* Lv, const void* aux, const void* cnt, const void* B, void* X,
           int64_t nblk, int64_t nb, int64_t nw, int64_t K, int64_t KC, void* stream, int64_t* launches) {
  if (nblk < 1 || nb < 1 || nb > kMaxNb || nw < 1 || nw > 1 << 20 || K < 1 ||
      K > INT32_MAX || (mode == kGather && cnt == nullptr) || nblk * nb >= INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout L = plan_layout(static_cast<int>(nb), static_cast<int>(KC), sizeof(T), sizeof(A));
  if (L.total > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a{static_cast<const T*>(dinvT), static_cast<const T*>(Lv), static_cast<const int32_t*>(aux),
            static_cast<const int32_t*>(cnt), static_cast<const T*>(B), static_cast<T*>(X),
            static_cast<int>(nblk), static_cast<int>(nb), static_cast<int>(nw), static_cast<int>(K)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nchunks = static_cast<int>((K + KC - 1) / KC);
  int rc;
  if (mode == kDwin && KC == 1) rc = launch_kc<T, A, kDwin, 1>(a, L, nchunks, st);
  else if (mode == kDwin && KC == 2) rc = launch_kc<T, A, kDwin, 2>(a, L, nchunks, st);
  else if (mode == kDwin && KC == 4) rc = launch_kc<T, A, kDwin, 4>(a, L, nchunks, st);
  else if (mode == kGather && KC == 1) rc = launch_kc<T, A, kGather, 1>(a, L, nchunks, st);
  else if (mode == kGather && KC == 2) rc = launch_kc<T, A, kGather, 2>(a, L, nchunks, st);
  else if (mode == kGather && KC == 4) rc = launch_kc<T, A, kGather, 4>(a, L, nchunks, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  if (rc == 0) *launches += 1;
  return rc;
}

}  // namespace

extern "C" {

#define TRSV_BLOCKED_ENTRY(name, T, A)                                                                              \
  int name(int64_t mode, const void* dinvT, const void* Lv, const void* aux, const void* cnt, const void* B, void* X, \
           int64_t nblk, int64_t nb, int64_t nw, int64_t K, int64_t KC, void* stream, int64_t* launches) {          \
    return launch<T, A>(mode, dinvT, Lv, aux, cnt, B, X, nblk, nb, nw, K, KC, stream, launches);                    \
  }

TRSV_BLOCKED_ENTRY(trsv_blocked_f32, float, float)
TRSV_BLOCKED_ENTRY(trsv_blocked_f64, double, double)
TRSV_BLOCKED_ENTRY(trsv_blocked_bf16, __nv_bfloat16, float)
TRSV_BLOCKED_ENTRY(trsv_blocked_c64, float2, float2)
TRSV_BLOCKED_ENTRY(trsv_blocked_c128, double2, double2)

// out[0..6] = D, H, slices S (helper groups a CTA), dinvT stages, threads a CTA, bytes
// of shared memory, near entries a row of a slot: the launch of an instance
// of element sizes te / ta at nb rows and KC columns
int trsv_blocked_layout(int64_t nb, int64_t KC, int64_t te, int64_t ta, int64_t* out) {
  if (nb < 1 || nb > kMaxNb) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = plan_layout(static_cast<int>(nb), static_cast<int>(KC), static_cast<size_t>(te),
                               static_cast<size_t>(ta));
  out[0] = L.D;
  out[1] = L.H;
  out[2] = L.Q;
  out[3] = L.P;
  out[4] = L.threads;
  out[5] = L.total;
  out[6] = L.NR;
  return L.total > kSmemBudget ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

}  // extern "C"
