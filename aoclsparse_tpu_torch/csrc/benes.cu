// Benes route for NVIDIA Hopper (sm_90a): a fixed permutation of n = 2^k
// float32 values applied as 2k-1 stages of conditional swaps,
//
//     stage t, stride s_t:  v'[i] = v[i ^ s_t]  where the stage's mask bit of i is set
//
// with strides 2^(k-1), ..., 2, 1, 2, ..., 2^(k-1). The masks are
// switch-symmetric (the bit of i equals the bit of i ^ s_t), so a stage
// swaps pairs. The packed masks are the JAX package's: stage t is bit t % 8
// of row t / 8 of a (ceil((2k-1)/8), n) uint8 array.
//
// Replaces aoclsparse_tpu/kernels/pallas/route_fused.py:73
// pallas_benes_apply (k in [7, 20], the whole vector VMEM-resident, every
// stage a pair of lane or sublane rolls). The route does no arithmetic, so
// the output is bit-equal to the Pallas kernel's on the same masks.
//
// What bounds it: bytes. The function reads v and the packed masks once and
// writes v once: (8 + ceil((2k-1)/8)) * 2^k bytes, 13.6 MB at k = 20. A
// 2^20-value vector does not fit in one SM's 227 KB, so no single CTA can
// hold it as the TPU's VMEM did.
//
// Design. Stages whose stride is below the tile of T = min(2^k, 4096)
// values never leave a tile: benes_tile_f32 runs them all (the middle
// 2*log2(T) - 1 stages) in one launch, one CTA a tile, with the tile's
// values and its mask rows staged in shared memory (16 KB + at most 4 x 4 KB)
// and a __syncthreads() between stages. The stages of stride T and above
// (the first and the last k - log2(T)) run as global passes,
// benes_pass_f32, G <= 4 consecutive stages a launch: a thread owns the 2^G
// values {i + sum of a subset of the G strides}, which every stage of the
// group maps onto itself, so it loads them once, applies the G stages in
// registers and stores them back (in place when src == dst). Consecutive
// threads own consecutive i, so every load and store is coalesced. At k = 20
// that is 8 + 8 stages in 4 passes around one tile launch of 23 stages.
// The same pass entry applies the unpacked outer stages of a k > 20 route
// (row r of a (S, n) 0/1 array: bit 0).
//
// Each entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileThreads = 512;
constexpr int kPassThreads = 256;
constexpr int kMaxGroup = 4;

struct Group {
  int64_t stride[kMaxGroup];  // stage strides, in stage order
  int64_t row[kMaxGroup];     // mask row of each stage
  int bit[kMaxGroup];         // bit of each stage in its mask row
  int ebit[kMaxGroup];        // each stage's bit in the thread's element index e
  int pos[kMaxGroup];         // log2 of the strides, ascending
};

__device__ __forceinline__ int64_t stride_of(int t, int k) {
  return t < k ? (int64_t(1) << (k - 1 - t)) : (int64_t(1) << (t - k + 1));
}

__global__ void __launch_bounds__(kTileThreads)
benes_tile_kernel(const float* src, float* dst, const uint8_t* __restrict__ masks, int64_t n,
                  int k, int tb, int t0, int t1) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = 1 << tb;
  float* vs = reinterpret_cast<float*>(smem);
  uint8_t* ms = smem + static_cast<size_t>(T) * sizeof(float);
  const int r0 = t0 / 8, r1 = t1 / 8;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * T;
  for (int i = threadIdx.x; i < T; i += kTileThreads) vs[i] = src[base + i];
  for (int r = r0; r <= r1; ++r) {
    const uint8_t* row = masks + static_cast<int64_t>(r) * n + base;
    uint8_t* mrow = ms + static_cast<size_t>(r - r0) * T;
    for (int i = threadIdx.x; i < T; i += kTileThreads) mrow[i] = row[i];
  }
  __syncthreads();
  for (int t = t0; t <= t1; ++t) {
    const int s = static_cast<int>(stride_of(t, k));
    const uint8_t* mrow = ms + static_cast<size_t>(t / 8 - r0) * T;
    const int b = t % 8;
    for (int p = threadIdx.x; p < T / 2; p += kTileThreads) {
      const int i = ((p & ~(s - 1)) << 1) | (p & (s - 1));  // bit s of i clear
      if ((mrow[i] >> b) & 1) {
        const float a = vs[i];
        vs[i] = vs[i | s];
        vs[i | s] = a;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < T; i += kTileThreads) dst[base + i] = vs[i];
}

template <int G>
__global__ void __launch_bounds__(kPassThreads)
benes_pass_kernel(const float* src, float* dst, const uint8_t* __restrict__ masks, int64_t n,
                  Group grp) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kPassThreads + threadIdx.x;
  if (q >= (n >> G)) return;
  int64_t i0 = q;  // q with a zero bit inserted at every stride's position
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int p = grp.pos[g];
    i0 = ((i0 >> p) << (p + 1)) | (i0 & ((int64_t(1) << p) - 1));
  }
  int64_t idx[1 << G];
  float v[1 << G];
#pragma unroll
  for (int e = 0; e < (1 << G); ++e) {
    int64_t off = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (e & (1 << g)) off += int64_t(1) << grp.pos[g];
    }
    idx[e] = i0 + off;
    v[e] = src[idx[e]];
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int eb = grp.ebit[g];
    const uint8_t* row = masks + grp.row[g] * n;
#pragma unroll
    for (int e = 0; e < (1 << G); ++e) {
      if (e & (1 << eb)) continue;
      if ((row[idx[e]] >> grp.bit[g]) & 1) {
        const float a = v[e];
        v[e] = v[e | (1 << eb)];
        v[e | (1 << eb)] = a;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < (1 << G); ++e) dst[idx[e]] = v[e];
}

}  // namespace

extern "C" {

// The stages t in [k - tb, k + tb - 2] (strides below 2^tb) of a packed
// route, one CTA per 2^tb-value tile; src may equal dst.
int benes_tile_f32(const void* src, void* dst, const void* masks, int64_t k, int64_t tb,
                   void* stream) {
  const int64_t n = int64_t(1) << k;
  const int t0 = static_cast<int>(k - tb), t1 = static_cast<int>(k + tb - 2);
  const int nrows = t1 / 8 - t0 / 8 + 1;
  const size_t smem = (static_cast<size_t>(1) << tb) * (sizeof(float) + nrows);
  benes_tile_kernel<<<static_cast<unsigned>(n >> tb), kTileThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst),
      static_cast<const uint8_t*>(masks), n, static_cast<int>(k), static_cast<int>(tb), t0, t1);
  return static_cast<int>(cudaGetLastError());
}

// g (1..4) stages in one global pass over n values: stage j has stride
// strides[j] (distinct powers of two) and reads bit bits[j] of mask row
// rows[j] (a row is n bytes); src may equal dst.
int benes_pass_f32(const void* src, void* dst, const void* masks, int64_t n, int64_t g,
                   const int64_t* strides, const int64_t* rows, const int64_t* bits,
                   void* stream) {
  if (g < 1 || g > kMaxGroup) return static_cast<int>(cudaErrorInvalidValue);
  Group grp{};
  int logs[kMaxGroup];
  for (int j = 0; j < g; ++j) {
    grp.stride[j] = strides[j];
    grp.row[j] = rows[j];
    grp.bit[j] = static_cast<int>(bits[j]);
    int l = 0;
    while ((int64_t(1) << l) < strides[j]) ++l;
    logs[j] = l;
  }
  for (int j = 0; j < g; ++j) {  // ascending positions, and each stage's e-bit
    int rank = 0;
    for (int i = 0; i < g; ++i) rank += logs[i] < logs[j];
    grp.pos[rank] = logs[j];
    grp.ebit[j] = rank;
  }
  const int64_t threads = n >> g;
  const unsigned blocks = static_cast<unsigned>((threads + kPassThreads - 1) / kPassThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(src);
  float* d = static_cast<float*>(dst);
  const uint8_t* m = static_cast<const uint8_t*>(masks);
  switch (g) {
    case 1: benes_pass_kernel<1><<<blocks, kPassThreads, 0, st>>>(s, d, m, n, grp); break;
    case 2: benes_pass_kernel<2><<<blocks, kPassThreads, 0, st>>>(s, d, m, n, grp); break;
    case 3: benes_pass_kernel<3><<<blocks, kPassThreads, 0, st>>>(s, d, m, n, grp); break;
    default: benes_pass_kernel<4><<<blocks, kPassThreads, 0, st>>>(s, d, m, n, grp); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
