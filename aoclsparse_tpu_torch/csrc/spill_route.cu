// Select and accumulate kernels of the spill-route SpMV engine for NVIDIA
// Hopper (sm_90a). The engine serves the gen form's unstructured spill and
// the whole-matrix `route` form (mv KID 14) in three phases: select (this
// file), a Benes route (csrc/benes.cu), accumulate (this file). The planner
// (aoclsparse_tpu_torch/planner/spill_route.py) packs the entries into
// 1024-slot chunks, grouped by 1024-wide x block for the select and by
// 1024-row y block for the accumulate.
//
// oh_select_f32 replaces aoclsparse_tpu/kernels/pallas/spill_route.py:66
// pallas_oh_select:
//
//     contrib[1024 c + s] = sel_val[c, s] * x[1024 sel_blk[c] + sel_idx[c, s]]
//
// for every chunk c and slot s, x read as 0 past its end. One f32 multiply,
// so the product is exact and equal to the Pallas kernel's (which pins
// HIGHEST precision for just that). The TPU picks x by a one-hot matrix
// product because it has no fast gather; Hopper has one, in shared memory.
//
// oh_accum_f32 replaces spill_route.py:126 pallas_oh_accum:
//
//     y_out[1024 b + r] = y_in[1024 b + r]
//                         + sum over chunks c with acc_blk[c] = b, cid = acc_cid[c] < n_real,
//                           and slots s with acc_idx[c, s] = r, of contrib[1024 cid + s]
//
// acc_blk is monotone and covers every y block (an untouched block carries
// one all-pad chunk whose cid is n_real, the zero tile), so the planner
// hands over blk_start[b], the first chunk of block b, and every y value
// is written once. The sum's order differs from the MXU contraction's and
// from run to run (shared-memory atomics): f32 rounding, not a bit-equal
// result.
//
// What bounds them: bytes. The select moves 12 bytes a slot (index, value,
// contribution) plus a 4 KB x block a chunk; the accumulate 12 bytes a slot
// plus a y block in and out. Neither does more than one flop a slot.
//
// Design. Select: one CTA per chunk, 256 threads. The CTA stages its
// chunk's 4 KB x block in shared memory (one 16-byte load a thread where
// the block is whole and aligned, masked scalar loads at the ragged end of
// x), then each thread reads 4 slots' indices and values as one int4 and
// one float4 and writes 4 contributions as one float4: every device access
// is a full 16-byte coalesced one. Accumulate: one CTA per 1024-row y
// block. It starts a shared-memory tile from y_in (masked at the ragged
// end), walks its run of chunks adding each slot with a shared-memory float
// atomic (pad slots carry exact zeros and are skipped), and writes the
// block once. y_out may be y_in: each CTA reads its own block before it
// writes it.
//
// Each entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() of the launch. Index
// and value pointers must be 16-byte aligned (the wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 1024;  // slots a chunk, rows a y block, columns an x block
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
oh_select_kernel(const float* __restrict__ x, int64_t n_x, const int* __restrict__ sel_idx,
                 const float* __restrict__ sel_val, const int* __restrict__ sel_blk,
                 float* __restrict__ out) {
  __shared__ __align__(16) float xs[kChunk];
  const int64_t c = blockIdx.x;
  const int64_t base = static_cast<int64_t>(sel_blk[c]) * kChunk;
  const int t = threadIdx.x;
  if (base + kChunk <= n_x && (reinterpret_cast<uintptr_t>(x + base) & 15) == 0) {
    reinterpret_cast<float4*>(xs)[t] = reinterpret_cast<const float4*>(x + base)[t];
  } else {
    for (int i = t; i < kChunk; i += kThreads) {
      xs[i] = (base + i < n_x) ? x[base + i] : 0.0f;
    }
  }
  __syncthreads();
  const int4 idx = reinterpret_cast<const int4*>(sel_idx + c * kChunk)[t];
  const float4 v = reinterpret_cast<const float4*>(sel_val + c * kChunk)[t];
  float4 o;
  o.x = v.x * xs[idx.x & (kChunk - 1)];
  o.y = v.y * xs[idx.y & (kChunk - 1)];
  o.z = v.z * xs[idx.z & (kChunk - 1)];
  o.w = v.w * xs[idx.w & (kChunk - 1)];
  reinterpret_cast<float4*>(out + c * kChunk)[t] = o;
}

__global__ void __launch_bounds__(kThreads)
oh_accum_kernel(const float* __restrict__ contrib, const int* __restrict__ acc_idx,
                const int* __restrict__ acc_cid, const int* __restrict__ blk_start,
                int64_t n_real, const float* y_in, float* y_out, int64_t n_y) {
  __shared__ float ys[kChunk];
  const int64_t b = blockIdx.x;
  const int64_t row0 = b * kChunk;
  const int t = threadIdx.x;
  for (int i = t; i < kChunk; i += kThreads) {
    ys[i] = (row0 + i < n_y) ? y_in[row0 + i] : 0.0f;
  }
  __syncthreads();
  const int c0 = blk_start[b], c1 = blk_start[b + 1];
  for (int c = c0; c < c1; ++c) {
    const int64_t cid = acc_cid[c];
    if (cid >= n_real) continue;  // the all-pad chunk of an untouched block
    const int4 idx = reinterpret_cast<const int4*>(acc_idx + static_cast<int64_t>(c) * kChunk)[t];
    const float4 v = reinterpret_cast<const float4*>(contrib + cid * kChunk)[t];
    if (v.x != 0.0f) atomicAdd(&ys[idx.x & (kChunk - 1)], v.x);
    if (v.y != 0.0f) atomicAdd(&ys[idx.y & (kChunk - 1)], v.y);
    if (v.z != 0.0f) atomicAdd(&ys[idx.z & (kChunk - 1)], v.z);
    if (v.w != 0.0f) atomicAdd(&ys[idx.w & (kChunk - 1)], v.w);
  }
  __syncthreads();
  for (int i = t; i < kChunk; i += kThreads) {
    if (row0 + i < n_y) y_out[row0 + i] = ys[i];
  }
}

}  // namespace

extern "C" {

int oh_select_f32(const void* x, int64_t n_x, const void* sel_idx, const void* sel_val,
                  const void* sel_blk, int64_t n_chunks, void* out, void* stream) {
  if (n_chunks <= 0) return 0;
  oh_select_kernel<<<static_cast<unsigned>(n_chunks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n_x, static_cast<const int*>(sel_idx),
      static_cast<const float*>(sel_val), static_cast<const int*>(sel_blk),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

int oh_accum_f32(const void* contrib, const void* acc_idx, const void* acc_cid,
                 const void* blk_start, int64_t n_real, const void* y_in, void* y_out,
                 int64_t n_y, int64_t n_yblk, void* stream) {
  if (n_yblk <= 0) return 0;
  oh_accum_kernel<<<static_cast<unsigned>(n_yblk), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(contrib), static_cast<const int*>(acc_idx),
      static_cast<const int*>(acc_cid), static_cast<const int*>(blk_start), n_real,
      static_cast<const float*>(y_in), static_cast<float*>(y_out), n_y);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
