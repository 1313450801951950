// Benes route for NVIDIA Hopper (sm_90a): a fixed permutation of n = 2^k
// float32 values applied as 2k-1 stages of conditional swaps,
//
//     stage t, stride 2^s_t:  v'[i] = v[i ^ 2^s_t]  where the stage's mask bit of i is set
//
// with strides 2^(k-1), ..., 2, 1, 2, ..., 2^(k-1). The masks are
// switch-symmetric (the bit of i equals the bit of i ^ 2^s_t), so a stage
// swaps pairs. The masks are the JAX package's plan (kernels/route.py
// plan_route_arrays): for k <= 20 one packed network, stage t at bit t % 8
// of row t / 8 of a (ceil((2k-1)/8), n) uint8 array; above it the first and
// last d = k - 20 stages unpacked (a (2d, n) 0/1 array) around 2^d packed
// subnetworks of 2^20 values each.
//
// Replaces aoclsparse_tpu/kernels/pallas/route_fused.py:73
// pallas_benes_apply (k in [7, 20], the whole vector VMEM-resident, every
// stage a pair of lane or sublane rolls) and the staged apply around it
// for k > 20. The route does no arithmetic, so the output is bit-equal to
// the Pallas kernel's on the same masks.
//
// What bounds it: bytes. The function reads v and the masks once and writes
// v once: 8 * 2^k bytes of values plus the masks, 31.5 MB at k = 21. A
// 2^20-value vector does not fit in one SM's 227 KB, so no single CTA can
// hold it as the TPU's VMEM did.
//
// Design: one kernel, benes_pass_kernel, run as a few passes over the
// vector (the schedule is kernels/benes.py route_passes). A pass owns a set
// of address bits: every CTA holds the 2^F values whose address has those
// bits free and the others fixed (its block index), so every stage whose
// stride is a free bit maps the CTA's set onto itself. Three passes cover a
// route:
//
//   A  the stages of stride >= 2^tb in the first half (the outer stages of a
//      split route and each subnetwork's strides 2^(kc-1) ... 2^tb): free
//      bits {0 .. c-1} and {tb .. k-1};
//   B  every stage of stride < 2^tb, in tiles of 2^tb consecutive values
//      (free bits {0 .. tb-1}); tile h reads its own subnetwork's masks;
//   C  the mirror of A.
//
// Choice: tb = 13 and c = 5. c = 5 makes each run of 32 values a full
// 128-byte line and each run of 32 mask bytes a full 32-byte sector. At
// k = 21, tb = 13 gives passes A and C sets of 2^(5 + 8) = 8,192 values
// and pass B tiles of 8,192 values: 256 CTAs of 66 KB of shared memory
// each, two an SM (so 64 registers a thread), in one wave; tb = 12 would
// leave A and C with 128 CTAs of twice that, one an SM. A pass whose set
// would not fit in shared memory is split into several passes of the same
// kernel by the schedule (first at k = 23).
//
// Within a CTA: the values are loaded once (16-byte loads, four a thread
// issued before any is used) and the mask bytes once (4-byte loads, one a
// mask row, at most four rows a pass), and each value's mask bits
// for the pass's stages are gathered into one 32-bit word (bit s: stage s;
// a packed row's byte gives its run of stages with one shift and mask).
// The stages then run in groups of up to four consecutive stages of
// distinct strides (the schedule's groups; a group never holds both
// stride-2 stages around the middle one): each thread takes the 16 values
// {base + any subset of the four strides} into registers, with their
// words, applies the four stages there and writes them back, so a group
// costs three shared-memory accesses a value, not two a stage; one
// __syncthreads() a group. A value's shared-memory slot is its local index
// plus one word per 32 (i + i / 32), which spreads a warp's 16-apart
// accesses of the smallest strides over the banks. The CTA stores once, in
// place when src == dst. What this leaves: the CTAs of a pass's one wave
// load, swap and store in step, so a pass's device traffic does not
// overlap its swaps (PERF.md). Loading straight into the first group's
// registers and storing from the last group's needs more than the 64
// registers two CTAs an SM allow, and spills.
//
// The group loop is unrolled over the kernel's group limit and a group's
// registers are indexed by the stage's position in the group, so no
// register array is indexed at run time and the kernel has no stack frame
// (-Xptxas -v).
//
// The entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() of the launch. Values
// and masks must be 16-byte aligned (the wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxRows = 4;     // mask rows a pass reads
constexpr int kBatch = 4;       // 16-byte value loads a thread keeps in flight
constexpr int kMaxStages = 32;  // stages a pass applies (one word bit each)
constexpr int kMaxGroups = 12;  // groups of up to 4 stages a pass applies
constexpr int kMaxSmem = 232448;

struct PassArgs {
  // mask byte of address i in row r: row_base[r][(i >> kc) * row_hstride[r] + (i & (2^kc - 1))];
  // its stages' bits go to the word as ((byte >> row_shift[r]) & row_mask[r]) << row_word[r]
  const uint8_t* row_base[kMaxRows];
  int64_t row_hstride[kMaxRows];
  int8_t row_shift[kMaxRows];
  uint8_t row_mask[kMaxRows];
  int8_t row_word[kMaxRows];
  int8_t glbit[kMaxGroups][4];  // each group's stages' bits in the CTA's local index
  int8_t gfirst[kMaxGroups];    // each group's first stage (its word bit)
  int8_t gsize[kMaxGroups];     // and its number of stages
  int nrows, ngroups;
  int c, blo, bhi;  // free address bits: [0, c) and [blo, bhi)
  int kc;           // log2 of a subnetwork's size
};

__device__ __forceinline__ int slot_of(int j) { return j + (j >> 5); }

// The local index of register e of a group at base: bit g of e at lb[g].
template <int G>
__device__ __forceinline__ int group_index(int base, int e, const int (&lb)[4]) {
  int j = base;
#pragma unroll
  for (int g = 0; g < G; ++g) j |= ((e >> g) & 1) << lb[g];
  return j;
}

// One group of G consecutive stages, s0 .. s0 + G - 1, at local bits lb[].
template <int G>
__device__ __forceinline__ void stage_group(float* vs, const uint32_t* ws, int F, int s0, const int (&lb)[4]) {
  int pos[G];  // the group's bits, ascending
#pragma unroll
  for (int g = 0; g < G; ++g) pos[g] = lb[g];
#pragma unroll
  for (int i = 0; i < G; ++i) {
#pragma unroll
    for (int g = 0; g + 1 < G - i; ++g) {
      const int lo = min(pos[g], pos[g + 1]), hi = max(pos[g], pos[g + 1]);
      pos[g] = lo;
      pos[g + 1] = hi;
    }
  }
  for (int p = threadIdx.x; p < (1 << (F - G)); p += kThreads) {
    int base = p;  // p with a zero bit inserted at each of the group's bits
#pragma unroll
    for (int g = 0; g < G; ++g) base = ((base >> pos[g]) << (pos[g] + 1)) | (base & ((1 << pos[g]) - 1));
    float v[1 << G];
    uint32_t w[1 << G];  // the group's mask bits of each value, stage s0 at bit 0
#pragma unroll
    for (int e = 0; e < (1 << G); ++e) {
      const int at = slot_of(group_index<G>(base, e, lb));
      v[e] = vs[at];
      w[e] = e + 1 < (1 << G) ? ws[at] >> s0 : 0;  // the last value is no pair's lower one
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < (1 << G); ++e) {
        if (e & (1 << g)) continue;
        if ((w[e] >> g) & 1) {
          const float t = v[e];
          v[e] = v[e | (1 << g)];
          v[e | (1 << g)] = t;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < (1 << G); ++e) vs[slot_of(group_index<G>(base, e, lb))] = v[e];
  }
}

// two CTAs an SM: a route's 256 sets run in one wave (64 registers a thread)
__global__ void __launch_bounds__(kThreads, 2)
benes_pass_kernel(const float* src, float* dst, const PassArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = a.c + a.bhi - a.blo;
  const int N = 1 << F;
  float* vs = reinterpret_cast<float*>(smem);
  uint32_t* ws = reinterpret_cast<uint32_t*>(vs + slot_of(N));
  const int64_t q = blockIdx.x;
  const int mid = a.blo - a.c;  // fixed bits between the two free ranges
  const int64_t fixed = ((q & ((int64_t(1) << mid) - 1)) << a.c) | ((q >> mid) << a.bhi);
  const int64_t kmask = (int64_t(1) << a.kc) - 1;
  const int cmask = (1 << a.c) - 1;
  // kBatch iterations' loads are issued before any of them is used
  for (int g0 = threadIdx.x; g0 < N / 4; g0 += kBatch * kThreads) {
    float4 v[kBatch];
    uint32_t b4[kBatch][kMaxRows];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = 4 * (g0 + u * kThreads);  // 4 consecutive local indices: 4 consecutive addresses
      if (j < N) {
        const int64_t i = (j & cmask) | (static_cast<int64_t>(j >> a.c) << a.blo) | fixed;
        v[u] = *reinterpret_cast<const float4*>(src + i);
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          b4[u][r] = r < a.nrows ? *reinterpret_cast<const uint32_t*>(
                                       a.row_base[r] + (i >> a.kc) * a.row_hstride[r] + (i & kmask))
                                 : 0u;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = 4 * (g0 + u * kThreads);
      if (j < N) {
        uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          const int sh = a.row_shift[r], wd = a.row_word[r];
          const uint32_t m = a.row_mask[r];  // 0 past the pass's rows
          w0 |= ((b4[u][r] >> sh) & m) << wd;
          w1 |= ((b4[u][r] >> (8 + sh)) & m) << wd;
          w2 |= ((b4[u][r] >> (16 + sh)) & m) << wd;
          w3 |= ((b4[u][r] >> (24 + sh)) & m) << wd;
        }
        const int at = slot_of(j);  // j .. j + 3 share j's 32-run: consecutive slots
        vs[at] = v[u].x;
        vs[at + 1] = v[u].y;
        vs[at + 2] = v[u].z;
        vs[at + 3] = v[u].w;
        ws[at] = w0;
        ws[at + 1] = w1;
        ws[at + 2] = w2;
        ws[at + 3] = w3;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) {
    if (gi < a.ngroups) {
      const int lb[4] = {a.glbit[gi][0], a.glbit[gi][1], a.glbit[gi][2], a.glbit[gi][3]};
      const int s0 = a.gfirst[gi];
      switch (a.gsize[gi]) {
        case 1: stage_group<1>(vs, ws, F, s0, lb); break;
        case 2: stage_group<2>(vs, ws, F, s0, lb); break;
        case 3: stage_group<3>(vs, ws, F, s0, lb); break;
        default: stage_group<4>(vs, ws, F, s0, lb); break;
      }
      __syncthreads();
    }
  }
  for (int g = threadIdx.x; g < N / 4; g += kThreads) {
    const int j = 4 * g;
    const int64_t i = (j & cmask) | (static_cast<int64_t>(j >> a.c) << a.blo) | fixed;
    const int at = slot_of(j);
    *reinterpret_cast<float4*>(dst + i) = make_float4(vs[at], vs[at + 1], vs[at + 2], vs[at + 3]);
  }
}

}  // namespace

extern "C" {

// One pass of a route over n = 2^k values (src may equal dst). outer: the
// (2d, 2^k) unpacked rows of a split route (may be null when d = 0);
// packed: the (2^d, rows_per_net, 2^kc) packed subnetworks. rows: nrows
// (kind, index, shift, mask, word) tuples, kind 0 an outer row and 1 a
// packed row, whose stages' bits go to the word as
// ((byte >> shift) & mask) << word; groups: ngroups (first stage, size,
// 4 local bits) tuples of consecutive stages of distinct local bits, in
// stage order (stage s is word bit s; a group's unused bits are 0). The free
// address bits are [0, c) and [blo, bhi), with 2 <= c <= blo <= bhi <= k.
int benes_pass_f32(const void* src, void* dst, const void* outer, const void* packed, int64_t k,
                   int64_t kc, int64_t rows_per_net, int64_t c, int64_t blo, int64_t bhi,
                   int64_t nrows, const int64_t* rows, int64_t ngroups, const int64_t* groups,
                   void* stream) {
  if (nrows < 0 || nrows > kMaxRows || ngroups < 1 || ngroups > kMaxGroups || c < 2 || blo < c ||
      bhi < blo || bhi > k || kc > k || kc < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int F = static_cast<int>(c + bhi - blo);
  if (F < 4 || F > 24) return static_cast<int>(cudaErrorInvalidValue);
  PassArgs a{};
  const int64_t n = int64_t(1) << k;
  for (int r = 0; r < nrows; ++r) {
    const int64_t* row = rows + 5 * r;
    if (row[2] < 0 || row[2] > 7 || row[3] < 1 || row[3] > 255 || row[4] < 0 || row[4] >= kMaxStages) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (row[0] == 0) {
      a.row_base[r] = static_cast<const uint8_t*>(outer) + row[1] * n;
      a.row_hstride[r] = int64_t(1) << kc;
    } else {
      a.row_base[r] = static_cast<const uint8_t*>(packed) + (row[1] << kc);
      a.row_hstride[r] = rows_per_net << kc;
    }
    a.row_shift[r] = static_cast<int8_t>(row[2]);
    a.row_mask[r] = static_cast<uint8_t>(row[3]);
    a.row_word[r] = static_cast<int8_t>(row[4]);
  }
  int next = 0;  // the groups cover stages 0 .. 31 at most, in order
  for (int gi = 0; gi < ngroups; ++gi) {
    const int64_t* grp = groups + 6 * gi;
    if (grp[0] != next || grp[1] < 1 || grp[1] > 4 || grp[0] + grp[1] > kMaxStages) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int seen = 0;
    for (int g = 0; g < 4; ++g) {
      const int64_t lb = g < grp[1] ? grp[2 + g] : 0;
      if (lb < 0 || lb >= F || (g < grp[1] && ((seen >> lb) & 1))) return static_cast<int>(cudaErrorInvalidValue);
      seen |= g < grp[1] ? 1 << lb : 0;
      a.glbit[gi][g] = static_cast<int8_t>(lb);
    }
    a.gfirst[gi] = static_cast<int8_t>(grp[0]);
    a.gsize[gi] = static_cast<int8_t>(grp[1]);
    next = static_cast<int>(grp[0] + grp[1]);
  }
  a.nrows = static_cast<int>(nrows);
  a.ngroups = static_cast<int>(ngroups);
  a.c = static_cast<int>(c);
  a.blo = static_cast<int>(blo);
  a.bhi = static_cast<int>(bhi);
  a.kc = static_cast<int>(kc);
  const int N = 1 << F;
  const size_t smem = static_cast<size_t>(N + (N >> 5)) * (sizeof(float) + sizeof(uint32_t));
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(benes_pass_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  benes_pass_kernel<<<static_cast<unsigned>(int64_t(1) << (k - F)), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(src),
                                                           static_cast<float*>(dst), a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
