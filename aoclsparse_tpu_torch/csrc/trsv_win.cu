// Blocked window triangular solve for NVIDIA Hopper (sm_90a), the solve of
// the planner's `win` TrsvForm with pre-inverted diagonal blocks, with K
// right-hand sides (K = 1 for trsv):
//
//     X_k = dinvT_k^T (B_k - lwT_k^T W),   W <- [W; X_k][-WL:],   W_0 = 0
//
// for blocks k = 0..nblk-1 of nb rows each, over the JAX package's
// transposed operands: dinvT (nblk, nb, nb) with dinvT[k] = Dinv_k^T, lwT
// (nblk, WL, nb) with lwT[k] = Lwin_k^T, and row-major B, X of
// (nblk*nb, K). W holds the WL solved rows X[blk0 - WL, blk0) that end at
// the block's first row (zeros before row 0). WL may exceed nb: the window
// then reaches back over several blocks, the semantics of
// kernels/xla/trsv.py:72-99.
//
// Replaces three TPU kernels of the JAX package, one contract:
//   aoclsparse_tpu/kernels/pallas/trsv.py:74   pallas_trsv_win_inv8 (8 blocks a step)
//   aoclsparse_tpu/kernels/pallas/trsv.py:114  pallas_trsv_win_inv  (1 block a step)
//   aoclsparse_tpu/kernels/pallas/trsv.py:160  pallas_trsm_win_inv  (K columns, B transposed)
// Their 8-block grouping, the identity padding of nblk, the (8, nb/8) lane
// layout of vectors and the transposed, 8-padded RHS are TPU layout with no
// counterpart here.
//
// What bounds it: on a TPU the grid runs in order on one core, so the
// Pallas kernels carry W from step to step and stream each block's nb*nb +
// WL*nb operand values once. On Hopper that chain of nblk heavy steps runs
// on one SM at its load latency (a 320 KB step of the bench ILU0 factor,
// nb = 256, WL = 64, took 20 us). But a block's solve splits:
//
//     X_k = C_k - P_k^T W,   C_k = dinvT_k^T B_k,   P_k = lwT_k dinvT_k (WL x nb)
//
// P depends on the values only, so the form builds it once per values
// (planner/triangular.py); and only the last R = min(WL, nb) rows of a
// block (its chain rows) enter the next block's window. Even so a chain
// step (a WL x R product, a barrier, the new window) costs about a
// microsecond of latency on one SM, whatever its threads' layout, so where
// the window is exactly the last block's chain rows (WL <= nb) the chain
// is also split: with T_k = P_k[:, r0:] (r0 = nb - R = nb - WL) the chain
// rows follow v_k = c_k - v_(k-1) T_k, and over a group of s blocks from
// block a, v_j = u_j - v_(a-1) F_j with u the group's own chain from a zero
// window and F_j = (-1)^(j-a) T_a ... T_j, built once per values with P
// (kernels/trsv_win.py win_solve_operands; s ~ sqrt(nblk), 32 at the bench
// shape). The launches of a solve:
//
//   A  win_block_kernel, every block in parallel: X_k <- C_k. Dinv_k is
//      lower triangular, so dinvT_k is upper triangular in (q, r): thread r
//      sums q = 0..r only, which skips the zero half (134.7 of 268.4 MB at
//      the bench shape, f32). Reads of dinvT are coalesced across r; B_k is
//      staged in shared memory, KC columns a row, so each loaded element of
//      dinvT serves KC sums held in registers.
//   B  win_chain_kernel, one CTA a chunk of KB <= 2 columns, walks the
//      steps: X_k[r0:] <- X_k[r0:] - P_k[:, r0:]^T W for the R chain rows,
//      then W takes them. Only the WL x R tail of the step's operand and R
//      rows of C are read per step (16 KB f32 at the bench shape), and they
//      do not depend on the chain: cp.async streams them into a ring of
//      shared-memory stages several steps ahead, so a step waits on shared
//      memory and two CTA barriers only. An operand larger than a stage (WL up to
//      8192) streams in tiles of `tt` window rows within the step. The
//      window is a circular buffer of WL rows of KB values in shared
//      memory. The CTA's rp * tg threads (rp = R rounded up to a warp)
//      split a step's window rows into tg slices: thread (g, r) sums its
//      slice for chain row r over its KB columns in registers; the slices'
//      sums meet in shared memory in slice order, and C minus their sum is
//      the new row. A grouped solve launches it twice:
//        L  one CTA a group (and chunk), all groups at once: u over the
//           group's s blocks from a zero window;
//        G  over the full groups' last blocks, their products F as the
//           operand: v of each group's last block (nblk / s steps);
//      and then
//   F  win_fix_kernel, the other blocks of the groups after the first in
//      parallel: v_j = u_j - v_(a-1) F_j.
//   C  win_fix_kernel, blocks k >= 1 in parallel, rows r < r0:
//      X_k[r] <- X_k[r] - P_k[:, r]^T W_(k-1), W_(k-1) being the final
//      chain rows of block k - 1. When WL >= nb, r0 = 0 and there is no
//      pass C.
// So a solve is 3 launches, 2 when WL >= nb; a grouped one 4 or 5; the
// bf16 instance adds its rounding launch (kernels/trsv_win.py
// solve_launches).
//
// Every sum runs in the operand dtype (f32 for bf16) in a fixed order (no atomics): the
// same inputs give the same bits. The order differs from the contract's
// (B - W lwT) dinvT, within the dtype's model tolerance; the grouped form
// adds one rounding of each product F to the dtype (they are built in
// float64), held to the same tolerance on tails T of spectral norm 0.95,
// where v F_j weighs in every block of a group (tests/
// test_torch_win_solve_passes.py). Rows of dinvT_k below its diagonal are
// never read: a non-finite B value in row q of a block leaves the block's
// rows r < q as a triangular solve gives them, where the contract's dense
// product (0 * Inf) gives NaN.
//
// The bf16 instance (win_solve_bf16) computes what the Pallas kernels
// compute on bf16 operands, where each jnp.dot accumulates in f32 and
// rounds to bf16 (preferred_element_type=w.dtype, kernels/pallas/trsv.py:
// 65-66, 106-108, 153-154) and the carried window is bf16 VMEM scratch.
// dinvT, B and X are bf16; P and F are f32, built from the bf16 blocks in
// float64 and rounded once to f32 (kernels/trsv_win.py
// win_solve_operands). f32 and not bf16, because the split form rounds
// where the Pallas kernel does not: a bf16 P would add a rounding of every
// window product to the Pallas kernel's roundings of s = w lwT and b - s,
// while with f32 products the kernel's only roundings are its outputs'.
// Every pass reads bf16 and sums in f32 into an f32 work copy of X; the
// chain rounds each chain row to bf16 as it enters the window (the Pallas
// kernel's bf16 window), so the rows the next blocks read are the bf16
// values they read there, and a last launch (win_round_kernel) rounds the
// work copy to the bf16 X. The chain's operand stages stay f32, so its
// shared-memory plan is the f32 instance's. An emulation of these passes
// differs from the Pallas kernel in interpret mode by one bf16 rounding
// (tests/test_torch_win_solve_passes.py), far inside the bf16 model
// tolerance (utils/tolerances.py: 4 sqrt(2^-6) = 0.5).
//
// Instances (plain C entry points, bound with ctypes):
//   win_solve_f32, win_solve_f64, win_solve_bf16
// Each launches the passes on the given stream, does not synchronise,
// allocates nothing (the bf16 instance's f32 work copy of X is the
// caller's `work`, null for the others), adds to *launches the number of
// kernels it launched, and returns the first CUDA error of an attribute
// call or a launch (0 on success). KC is the column chunk of passes A, C and F
// (16, 8, 4, 2 or 1); group is s, or 0 for the plain chain (F unused); tg,
// tt and stages are the chain's slices, tile rows and ring depth
// (kernels/trsv_win.py chain_plan).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 1024;
// threads a CTA may have for a chunk of several columns, so that a thread
// has the registers for its KC sums and a row of KC values
constexpr int kChunkThreads = 512;
constexpr int kMaxStages = 16;

__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }

// an operand value in the sums' dtype (bf16 operands widen to f32)
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

// a chain row as it enters the window: rounded to bf16 by the bf16
// instance (rb != 0), as it is
__device__ __forceinline__ float window_value(float x, int rb) {
  return rb ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}
__device__ __forceinline__ double window_value(double x, int) { return x; }

__host__ __device__ constexpr int64_t round_up(int64_t v, int64_t m) { return (v + m - 1) / m * m; }

// shared-memory row stride of KC columns, in values: KC padded to a 16-byte
// multiple plus one 16-byte vector (writes of neighbouring rows spread over
// the banks); scalar rows when KC is below one vector
template <typename T, int KC>
__host__ __device__ constexpr int row_stride() {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  return KC >= V ? KC + V : (KC > 1 ? KC + 1 : 1);
}

// row stride of the chain's per-slice sums and staged C rows, read a value
// a thread at neighbouring rows: odd, so a warp's reads hit distinct banks
template <int KC>
__host__ __device__ constexpr int sum_stride() {
  return KC == 1 ? 1 : KC + 1;
}

// KC values of a shared-memory row to registers and back, in 16-byte
// vectors where the row allows
__device__ __forceinline__ void unpack(float4 x, float* v) { v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w; }
__device__ __forceinline__ void unpack(double2 x, double* v) { v[0] = x.x; v[1] = x.y; }
__device__ __forceinline__ float4 pack(const float* v) { return make_float4(v[0], v[1], v[2], v[3]); }
__device__ __forceinline__ double2 pack(const double* v) { return make_double2(v[0], v[1]); }

template <typename T, int KC>
__device__ __forceinline__ void load_row(const T* p, T* v) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if constexpr (KC >= V) {
    using Vec = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
#pragma unroll
    for (int i = 0; i < KC / V; ++i) unpack(reinterpret_cast<const Vec*>(p)[i], v + i * V);
  } else {
#pragma unroll
    for (int c = 0; c < KC; ++c) v[c] = p[c];
  }
}

template <typename T, int KC>
__device__ __forceinline__ void store_row(T* p, const T* v) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if constexpr (KC >= V) {
    using Vec = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
#pragma unroll
    for (int i = 0; i < KC / V; ++i) reinterpret_cast<Vec*>(p)[i] = pack(v + i * V);
  } else {
#pragma unroll
    for (int c = 0; c < KC; ++c) p[c] = v[c];
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

// one value
__device__ __forceinline__ void cp_async1(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async1(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most `pending` of this thread's copy groups are in flight
// (the instruction takes an immediate)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
#define WIN_WAIT(N) \
  case N: asm volatile("cp.async.wait_group " #N ";\n" ::: "memory"); break;
    WIN_WAIT(1) WIN_WAIT(2) WIN_WAIT(3) WIN_WAIT(4) WIN_WAIT(5) WIN_WAIT(6) WIN_WAIT(7)
    WIN_WAIT(8) WIN_WAIT(9) WIN_WAIT(10) WIN_WAIT(11) WIN_WAIT(12) WIN_WAIT(13) WIN_WAIT(14)
#undef WIN_WAIT
    default: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
  }
}

// ---- pass A: X_k <- dinvT_k^T B_k over the upper triangle ------------------

// TI: the operands' dtype; T: the sums' and X's (bf16 operands: f32)
template <typename TI, typename T, int KC>
__global__ void __launch_bounds__(KC == 1 ? kMaxThreads : kChunkThreads)
win_block_kernel(const TI* __restrict__ dinvT, const TI* __restrict__ B, T* __restrict__ X, int nb, int64_t K,
                 int64_t nchunk) {
  constexpr int KCP = row_stride<T, KC>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bs = reinterpret_cast<T*>(smem_raw);  // nb rows: B_k's column chunk

  const int64_t k = blockIdx.x / nchunk;
  const int64_t c0 = (blockIdx.x - k * nchunk) * KC;
  const int kc = static_cast<int>(K - c0 < KC ? K - c0 : KC);  // live columns of this chunk
  const int r = threadIdx.x;
  const int64_t blk0 = k * nb;
  if (r < nb) {
    const TI* br = B + (blk0 + r) * K + c0;
    T v[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) v[c] = c < kc ? widen(br[c]) : static_cast<T>(0);
    store_row<T, KC>(bs + r * KCP, v);
  }
  __syncthreads();
  if (r >= nb) return;
  T acc[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) acc[c] = static_cast<T>(0);
  const TI* dk = dinvT + k * nb * static_cast<int64_t>(nb) + r;
  // the bf16 instance widens each value: a shallower unroll keeps its KC = 8
  // chunk's sums and staged rows in registers (8 deep spilled)
#pragma unroll (sizeof(TI) < sizeof(T) ? 4 : 8)
  for (int q = 0; q <= r; ++q) {
    const T d = widen(__ldg(dk + static_cast<int64_t>(q) * nb));
    T v[KC];
    load_row<T, KC>(bs + q * KCP, v);
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[c] = mul_add(v[c], d, acc[c]);
  }
  T* xr = X + (blk0 + r) * K + c0;
#pragma unroll
  for (int c = 0; c < KC; ++c)
    if (c < kc) xr[c] = acc[c];
}

// ---- pass B: the chain over the blocks' last R rows ------------------------

// the chain's column chunk: at most 2 columns a CTA, so that the chunks'
// chains run side by side, one SM each, and a step's products are few
template <int KC>
__host__ __device__ constexpr int chain_cols() {
  return KC < 2 ? KC : 2;
}

// values of one ring stage: tt rows of P's tail (rows padded to 16 bytes)
// and R rows of C, padded to 16 bytes
template <typename T, int KC>
__host__ __device__ int64_t stage_values(int R, int tt) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  return round_up(static_cast<int64_t>(tt) * round_up(R, V) + static_cast<int64_t>(R) * sum_stride<KC>(), V);
}

// values before the ring: the window and the slices' sums
template <typename T, int KC>
__host__ __device__ int64_t chain_head_values(int R, int WL, int tg) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int64_t red = tg > 1 ? round_up(static_cast<int64_t>(tg) * R * sum_stride<KC>(), V) : 0;
  return round_up(static_cast<int64_t>(WL) * row_stride<T, KC>(), V) + red;
}

// the copies of one tile, walked without division: copy e = tid + m *
// blockDim.x of a tile is row i = e / cw, column q = e % cw of the tile's
// rows of cw copies each; (di, dq) is blockDim.x in the same terms
struct CopyWalk {
  int i0, q0, di, dq, cw;
  __device__ CopyWalk(int cw_) : cw(cw_) {
    i0 = static_cast<int>(threadIdx.x) / cw;
    q0 = static_cast<int>(threadIdx.x) - i0 * cw;
    di = static_cast<int>(blockDim.x) / cw;
    dq = static_cast<int>(blockDim.x) - di * cw;
  }
  __device__ __forceinline__ void next(int& i, int& q) const {
    i += di;
    q += dq;
    if (q >= cw) q -= cw, ++i;
  }
};

// where a chain's steps read and write: step k's operand is WL rows at
// stride nbp from P + k pstride, of which the last R columns are read; its
// R chain rows are X rows xoff + k xstride + [0, R). The plain chain: the
// blocks' P tails and chain rows (pstride = WL nb, nbp = nb, xoff = nb - R,
// xstride = nb); the group chain of a grouped solve: the groups' products
// F and their last blocks' chain rows
template <typename T>
struct ChainAddr {
  const T* P;
  int64_t pstride;
  int nbp;
  int64_t xoff, xstride;
};

// issue the copies of tile j of step k (window rows [j tt, j tt + tn) of
// the step's operand, rows padded to rs values) into `stage`; the step's
// last tile also brings its R chain rows of C (pass A's output in X)
template <typename T, int KC>
__device__ __forceinline__ void chain_load(T* stage, const ChainAddr<T>& ad, const T* __restrict__ X, int64_t k,
                                           int j, int nt, int tt, int WL, int R, int rs, int64_t K, int64_t c0,
                                           bool vec, const CopyWalk& pw, const CopyWalk& cw) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int CS = sum_stride<KC>();
  const int t0 = j * tt;
  const int tn = WL - t0 < tt ? WL - t0 : tt;
  const int nbp = ad.nbp;
  const T* src = ad.P + k * ad.pstride + static_cast<int64_t>(t0) * nbp + (nbp - R);
  if (vec) {
    for (int i = pw.i0, q = pw.q0; i < tn; pw.next(i, q))
      cp_async16(stage + i * rs + q * V, src + static_cast<int64_t>(i) * nbp + q * V);
  } else {
    for (int i = pw.i0, q = pw.q0; i < tn; pw.next(i, q)) cp_async1(stage + i * rs + q, src + static_cast<int64_t>(i) * nbp + q);
  }
  if (j == nt - 1) {
    T* cs = stage + tt * rs;
    const T* xs = X + (ad.xoff + k * ad.xstride) * K + c0;
    for (int i = cw.i0, c = cw.q0; i < R; cw.next(i, c)) cp_async1(cs + i * CS + c, xs + static_cast<int64_t>(i) * K + c);
  }
}

// acc[c] += sum_{i < n} win[slot + i][c] * p[i * rs]: n window rows from
// slot on (no wrap), against the thread's column of P's tail
template <typename T, int KC>
__device__ __forceinline__ void chain_rows(T* acc, const T* p, int rs, const T* win, int n) {
  constexpr int KCP = row_stride<T, KC>();
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const T pv = p[i * rs];
    T v[KC];
    load_row<T, KC>(win + i * KCP, v);
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[c] = mul_add(v[c], pv, acc[c]);
  }
}

// a chain of steps k = k0 .. k0 + nsteps - 1, k0 = blockIdx.y gsteps (each
// CTA of a grouped solve's pass L walks one group, from a zero window):
// X[step k's chain rows] <- C - W . T_k, W the WL rows the previous steps
// wrote (zero before the first), T_k the last R columns of step k's operand
template <typename T, int KC>
__global__ void __launch_bounds__(KC == 1 ? kMaxThreads : kChunkThreads)
win_chain_kernel(const ChainAddr<T> ad, T* __restrict__ X, int64_t ksteps, int64_t gsteps, int nbm, int WL, int R,
                 int64_t K, int tg, int tt, int stages, int vec, int rb) {
  constexpr int KCP = row_stride<T, KC>();
  constexpr int CS = sum_stride<KC>();
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rp = (R + 31) / 32 * 32;
  const int rs = static_cast<int>(round_up(R, V));
  const int nt = (WL + tt - 1) / tt;  // tiles a step
  const int64_t sv = stage_values<T, KC>(R, tt);
  T* win = reinterpret_cast<T*>(smem_raw);  // WL rows of KCP: circular window
  T* red = win + round_up(static_cast<int64_t>(WL) * KCP, V);  // tg * R rows of CS: the slices' sums
  T* ring = win + chain_head_values<T, KC>(R, WL, tg);          // stages of sv values

  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * gsteps;
  const int64_t nsteps = ksteps - k0 < gsteps ? ksteps - k0 : gsteps;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * KC;
  const int kc = static_cast<int>(K - c0 < KC ? K - c0 : KC);
  const int g = threadIdx.x / rp;  // the thread's slice of a tile's window rows
  const int rl = threadIdx.x - g * rp;  // its chain row
  const bool active = rl < R;
  const int64_t total = nsteps * nt;
  const CopyWalk pw(vec ? R / V : R), cw(kc);
  // the slice's rows of a full tile and of the last one
  const int ts = (tt + tg - 1) / tg, tl = WL - (nt - 1) * tt, tsl = (tl + tg - 1) / tg;
  const int i0f = g * ts < tt ? g * ts : tt, i1f = i0f + ts < tt ? i0f + ts : tt;
  const int i0l = g * tsl < tl ? g * tsl : tl, i1l = i0l + tsl < tl ? i0l + tsl : tl;
  // the steps are d rows apart (the plain chain: d = nb; the group chain:
  // d = WL), nbm = d % WL: window position t of a step holds the row WL - t
  // before the step's first, at slot (head + t) % WL, and the step's chain
  // row rl (row d - R + rl) goes to slot (head + rrel) % WL, head advancing
  // by nbm a step
  const int rrel = (nbm + WL - R + rl) % WL;

  for (int i = threadIdx.x; i < WL * KCP; i += blockDim.x) win[i] = static_cast<T>(0);
  // prologue: tiles 0 .. stages-2 in flight, one copy group each
  int64_t kf = k0;  // the tile to fetch next (step kf, tile jf) and its stage
  int jf = 0, sf = 0;
  for (; sf < stages - 1; ++sf) {
    if (sf < total) chain_load<T, KC>(ring + sf * sv, ad, X, kf, jf, nt, tt, WL, R, rs, K, c0, vec != 0, pw, cw);
    cp_async_commit();
    if (++jf == nt) jf = 0, ++kf;
  }

  T acc[KC];
  int j = 0, s = 0, head = 0;
  T* xrow = X + (ad.xoff + k0 * ad.xstride + rl) * K + c0;  // the thread's chain row of the current step
  for (int64_t n = 0; n < total; ++n) {
    cp_async_wait(stages - 2);  // this thread's copies of tile n have landed
    __syncthreads();            // everyone's have; the previous tile's stage and window writes are done
    if (n + stages - 1 < total)  // tile n + stages - 1 into the stage of tile n - 1
      chain_load<T, KC>(ring + sf * sv, ad, X, kf, jf, nt, tt, WL, R, rs, K, c0, vec != 0, pw, cw);
    cp_async_commit();
    if (++jf == nt) jf = 0, ++kf;
    if (++sf == stages) sf = 0;

    const T* st = ring + s * sv;
    if (j == 0) {
#pragma unroll
      for (int c = 0; c < KC; ++c) acc[c] = static_cast<T>(0);
    }
    const bool last = j == nt - 1;
    const int i0 = last ? i0l : i0f, i1 = last ? i1l : i1f;
    if (active && i1 > i0) {
      int slot = head + j * tt + i0;
      if (slot >= WL) slot -= WL;
      const int n1 = i1 - i0 < WL - slot ? i1 - i0 : WL - slot;
      const T* p = st + i0 * rs + rl;
      chain_rows<T, KC>(acc, p, rs, win + slot * KCP, n1);
      chain_rows<T, KC>(acc, p + n1 * rs, rs, win, i1 - i0 - n1);
    }
    if (++s == stages) s = 0;
    if (!last) {
      ++j;
      continue;
    }
    j = 0;
    // the step's end: every read of the window is done; the slices' sums meet
    if (tg > 1 && active) {
#pragma unroll
      for (int c = 0; c < KC; ++c) red[(g * R + rl) * CS + c] = acc[c];
    }
    __syncthreads();
    if (active) {
      const T* cs = st + tt * rs + rl * CS;
      int slot = head + rrel;
      if (slot >= WL) slot -= WL;
      T* wrow = win + slot * KCP;
      if (tg == 1) {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const T x = window_value(cs[c] - acc[c], rb);
          wrow[c] = x;
          if (c < kc) xrow[c] = x;
        }
      } else {
        for (int c = g; c < KC; c += tg) {
          T sum = red[rl * CS + c];
          for (int h = 1; h < tg; ++h) sum += red[(h * R + rl) * CS + c];
          const T x = window_value(cs[c] - sum, rb);
          wrow[c] = x;
          if (c < kc) xrow[c] = x;
        }
      }
    }
    head += nbm;
    if (head >= WL) head -= WL;
    xrow += ad.xstride * K;
  }
  cp_async_wait(0);
}

// ---- passes C and F: rows of many blocks in parallel, from final windows --

// block j (one CTA a block and column chunk) takes X[rows] -= W . Q_j[:, :nr]
// for the nr rows from orow(j), W the WL X rows that end at wend(j) (all
// final), Q_j nr columns of WL rows at stride qn from Q + j qstride.
//   pass C (group = 0): blocks j >= 1, rows [0, nb - WL), W ending at the
//     block's first row, Q = P's head columns (qn = nb);
//   pass F (group = s): blocks j of groups >= 1 but the full groups' last
//     blocks, their WL chain rows, W the chain rows of the group's start -
//     1, Q = the prefix products F (qn = WL)
template <typename T, int KC>
__global__ void __launch_bounds__(KC == 1 ? kMaxThreads : kChunkThreads)
win_fix_kernel(const T* __restrict__ Q, int64_t qstride, int qn, T* __restrict__ X, int nb, int WL, int64_t K,
               int64_t nchunk, int64_t nblk, int64_t group, int rb) {
  constexpr int KCP = row_stride<T, KC>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w = reinterpret_cast<T*>(smem_raw);  // WL rows of the window

  const int64_t first = group ? group : 1;
  const int64_t j = first + blockIdx.x / nchunk;
  const int64_t c0 = (blockIdx.x - (j - first) * nchunk) * KC;
  const int kc = static_cast<int>(K - c0 < KC ? K - c0 : KC);
  int nr, orow;
  int64_t wend;
  if (group) {
    const int64_t a = j / group * group;  // the group's first block
    if (j % group == group - 1 && (j / group + 1) * group <= nblk) return;  // the group chain wrote it
    nr = WL;
    orow = nb - WL;
    wend = a * nb;
  } else {
    nr = nb - WL;
    orow = 0;
    wend = j * nb;
  }
  for (int t = threadIdx.x; t < WL; t += blockDim.x) {
    const T* xr = X + (wend - WL + t) * K + c0;
    T v[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) v[c] = c < kc ? xr[c] : static_cast<T>(0);
    store_row<T, KC>(w + t * KCP, v);
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= nr) return;
  T acc[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) acc[c] = static_cast<T>(0);
  const T* qk = Q + j * qstride + r;
#pragma unroll 4
  for (int t = 0; t < WL; ++t) {
    const T q = __ldg(qk + static_cast<int64_t>(t) * qn);
    T v[KC];
    load_row<T, KC>(w + t * KCP, v);
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[c] = mul_add(v[c], q, acc[c]);
  }
  // pass F writes chain rows, which the bf16 instance rounds as window rows
  T* xr = X + (j * nb + orow + r) * K + c0;
  const int rw = group ? rb : 0;
#pragma unroll
  for (int c = 0; c < KC; ++c)
    if (c < kc) xr[c] = window_value(xr[c] - acc[c], rw);
}

// ---- the bf16 instance's last launch: X <- its f32 work copy, rounded ------

__global__ void win_round_kernel(const float* __restrict__ W, __nv_bfloat16* __restrict__ X, int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    X[i] = __float2bfloat16_rn(W[i]);
}

template <typename K_>
int set_smem(K_ kernel, size_t bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <typename T, int KB>
int launch_chain(const ChainAddr<T>& ad, void* X, int64_t ksteps, int64_t gsteps, int nbm, int WL, int R, int64_t K,
                 int64_t tg, int64_t tt, int64_t stages, int rb, cudaStream_t s, int64_t& launches) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int rp = (R + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(chain_head_values<T, KB>(R, WL, static_cast<int>(tg)) +
                                          stages * stage_values<T, KB>(R, static_cast<int>(tt))) *
                      sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(ad.P) % 16 == 0 && ad.nbp % V == 0 && (ad.nbp - R) % V == 0 &&
                   R % V == 0 && ad.pstride % V == 0;
  int err;
  if ((err = set_smem(win_chain_kernel<T, KB>, smem)) != 0) return err;
  const dim3 grid(static_cast<unsigned>((K + KB - 1) / KB), static_cast<unsigned>((ksteps + gsteps - 1) / gsteps));
  win_chain_kernel<T, KB><<<grid, static_cast<unsigned>(rp * tg), smem, s>>>(
      ad, static_cast<T*>(X), ksteps, gsteps, nbm, WL, R, K, static_cast<int>(tg), static_cast<int>(tt),
      static_cast<int>(stages), vec ? 1 : 0, rb);
  if ((err = static_cast<int>(cudaGetLastError())) == 0) ++launches;
  return err;
}

template <typename T, int KC>
int launch_fix(const void* Q, int64_t qstride, int qn, void* X, int64_t nb, int64_t WL, int64_t K, int64_t nblk,
               int64_t group, int nr, int rb, cudaStream_t s, int64_t& launches) {
  constexpr int KCP = row_stride<T, KC>();
  const int64_t nchunk = (K + KC - 1) / KC;
  const int64_t blocks = nblk - (group ? group : 1);
  if (blocks <= 0 || nr <= 0) return 0;
  const size_t smem = static_cast<size_t>(WL) * KCP * sizeof(T);
  int err;
  if ((err = set_smem(win_fix_kernel<T, KC>, smem)) != 0) return err;
  win_fix_kernel<T, KC><<<static_cast<unsigned>(blocks * nchunk), static_cast<unsigned>((nr + 31) / 32 * 32), smem,
                          s>>>(static_cast<const T*>(Q), qstride, qn, static_cast<T*>(X), static_cast<int>(nb),
                               static_cast<int>(WL), K, nchunk, nblk, group, rb);
  if ((err = static_cast<int>(cudaGetLastError())) == 0) ++launches;
  return err;
}

// the passes of one solve; F and `group` (> 0) for a grouped solve. TI is
// the operands' dtype, T the sums' and X's: for TI != T (bf16) X is the f32
// work copy, which the chain rounds into the window (rb) and the caller
// rounds to the output
template <typename TI, typename T, int KC>
int launch_kc(const void* dinvT, const void* P, const void* F, const void* B, void* X, int64_t nblk, int64_t nb,
              int64_t WL, int64_t K, int64_t group, int64_t tg, int64_t tt, int64_t stages, void* stream,
              int64_t& launches) {
  constexpr int rb = std::is_same<TI, T>::value ? 0 : 1;
  constexpr int KCP = row_stride<T, KC>();
  constexpr int KB = chain_cols<KC>();
  constexpr int kThreads = KC == 1 ? kMaxThreads : kChunkThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nchunk = (K + KC - 1) / KC;
  const int R = static_cast<int>(WL < nb ? WL : nb);
  const int r0 = static_cast<int>(nb - R);
  const int64_t rp = (R + 31) / 32 * 32;
  if (nb < 1 || nb > kThreads || WL < 1 || tg < 1 || tt < 1 || tt > WL || stages < 2 || stages > kMaxStages ||
      rp * tg > kThreads || group < 0 || (group > 0 && (WL > nb || !F)))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* Pt = static_cast<const T*>(P);
  const T* Ft = static_cast<const T*>(F);
  int err;

  // A
  const size_t smem_a = static_cast<size_t>(nb) * KCP * sizeof(T);
  if ((err = set_smem(win_block_kernel<TI, T, KC>, smem_a)) != 0) return err;
  win_block_kernel<TI, T, KC><<<static_cast<unsigned>(nblk * nchunk), static_cast<unsigned>((nb + 31) / 32 * 32),
                                smem_a, s>>>(static_cast<const TI*>(dinvT), static_cast<const TI*>(B),
                                             static_cast<T*>(X), static_cast<int>(nb), K, nchunk);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  ++launches;

  // B: the plain chain over the blocks, or pass L (each group's chain from
  // a zero window)
  const ChainAddr<T> blocks{Pt, WL * nb, static_cast<int>(nb), r0, nb};
  const int nbm = static_cast<int>(nb % WL);
  if ((err = launch_chain<T, KB>(blocks, X, nblk, group ? group : nblk, nbm, static_cast<int>(WL), R, K, tg, tt,
                                 stages, rb, s, launches)) != 0)
    return err;
  if (group) {
    // G: the chain over the full groups' last blocks, through their products
    const int64_t full = nblk / group;
    if (full >= 2) {
      const ChainAddr<T> groups{Ft + (group - 1) * WL * WL, group * WL * WL, static_cast<int>(WL),
                                (group - 1) * nb + r0, group * nb};
      if ((err = launch_chain<T, KB>(groups, X, full, full, 0, static_cast<int>(WL), R, K, tg, tt, stages, rb, s,
                                     launches)) != 0)
        return err;
    }
    // F: every other block of the groups after the first
    if ((err = launch_fix<T, KC>(Ft, WL * WL, static_cast<int>(WL), X, nb, WL, K, nblk, group, R, rb, s,
                                 launches)) != 0)
      return err;
  }

  // C
  if (r0 > 0 && nblk > 1)
    if ((err = launch_fix<T, KC>(Pt, WL * nb, static_cast<int>(nb), X, nb, WL, K, nblk, 0, r0, rb, s, launches)) !=
        0)
      return err;
  return 0;
}

// X is the output; the bf16 instance (TI != T) sums into `work` (f32, the
// shape of X) and rounds it to X in a last launch
template <typename TI, typename T>
int launch(const void* dinvT, const void* P, const void* F, const void* B, void* X, void* work, int64_t nblk,
           int64_t nb, int64_t WL, int64_t K, int64_t KC, int64_t group, int64_t tg, int64_t tt, int64_t stages,
           void* stream, int64_t* launches) {
  constexpr bool rounds = !std::is_same<TI, T>::value;
  void* Xw = rounds ? work : X;
  int64_t n = 0;
  int err = 0;
  if (rounds && !work) return static_cast<int>(cudaErrorInvalidValue);
  if (nblk > 0 && K > 0) {
    switch (KC) {
      case 16: err = launch_kc<TI, T, 16>(dinvT, P, F, B, Xw, nblk, nb, WL, K, group, tg, tt, stages, stream, n); break;
      case 8: err = launch_kc<TI, T, 8>(dinvT, P, F, B, Xw, nblk, nb, WL, K, group, tg, tt, stages, stream, n); break;
      case 4: err = launch_kc<TI, T, 4>(dinvT, P, F, B, Xw, nblk, nb, WL, K, group, tg, tt, stages, stream, n); break;
      case 2: err = launch_kc<TI, T, 2>(dinvT, P, F, B, Xw, nblk, nb, WL, K, group, tg, tt, stages, stream, n); break;
      case 1: err = launch_kc<TI, T, 1>(dinvT, P, F, B, Xw, nblk, nb, WL, K, group, tg, tt, stages, stream, n); break;
      default: err = static_cast<int>(cudaErrorInvalidValue);
    }
    if (rounds && err == 0) {
      const int64_t total = nblk * nb * K;
      const int64_t blocks = (total + 255) / 256;
      win_round_kernel<<<static_cast<unsigned>(blocks < 65536 ? blocks : 65536), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(work),
                                                              static_cast<__nv_bfloat16*>(X), total);
      if ((err = static_cast<int>(cudaGetLastError())) == 0) ++n;
    }
  }
  if (launches) *launches += n;
  return err;
}

}  // namespace

extern "C" {

int win_solve_f32(const void* dinvT, const void* P, const void* F, const void* B, void* X, void* work, int64_t nblk,
                  int64_t nb, int64_t WL, int64_t K, int64_t KC, int64_t group, int64_t tg, int64_t tt,
                  int64_t stages, void* stream, int64_t* launches) {
  return launch<float, float>(dinvT, P, F, B, X, work, nblk, nb, WL, K, KC, group, tg, tt, stages, stream, launches);
}

int win_solve_f64(const void* dinvT, const void* P, const void* F, const void* B, void* X, void* work, int64_t nblk,
                  int64_t nb, int64_t WL, int64_t K, int64_t KC, int64_t group, int64_t tg, int64_t tt,
                  int64_t stages, void* stream, int64_t* launches) {
  return launch<double, double>(dinvT, P, F, B, X, work, nblk, nb, WL, K, KC, group, tg, tt, stages, stream,
                                launches);
}

int win_solve_bf16(const void* dinvT, const void* P, const void* F, const void* B, void* X, void* work, int64_t nblk,
                   int64_t nb, int64_t WL, int64_t K, int64_t KC, int64_t group, int64_t tg, int64_t tt,
                   int64_t stages, void* stream, int64_t* launches) {
  return launch<__nv_bfloat16, float>(dinvT, P, F, B, X, work, nblk, nb, WL, K, KC, group, tg, tt, stages, stream,
                                      launches);
}

}  // extern "C"
