// Streaming-read probe for NVIDIA Hopper (sm_90a): the float32 sum of a
// contiguous float32 slab of N values,
//
//     out = sum_{e < N} v[e]
//
// Replaces aoclsparse_tpu/kernels/pallas/spmv.py:364 pallas_stream_read, the
// JAX package's achievable-read-rate calibrator (bench.py:320-350), which
// reduces an (R, C) slab tile by tile through the band kernels' grid
// pipeline. Its purpose carries over: a kernel that does nothing but read,
// so that its time gives the card's own achievable read rate beside the
// data-sheet peak. The TPU's (R, TM) tiles and (8, 128) partial blocks stay
// behind.
//
// What bounds it: N * 4 bytes read once and one add a value: device-memory
// bandwidth. Design: pass 1 runs `nblocks` CTAs of 256 threads (the wrapper
// sizes it to a few CTAs an SM); each thread walks the slab grid-stride in
// 16-byte loads (float4), four loads in flight, and sums in float32; a warp
// shuffle and a shared-memory step reduce the CTA to one partial. Pass 2,
// one CTA, reduces the partials in a fixed order. The first N % 4 values
// before a 16-byte boundary do not occur (the wrapper requires a 16-byte
// aligned slab); the last N % 4 are summed by CTA 0. No atomics: the order
// of every sum is fixed by N and nblocks, so repeated calls give the same
// bits.
//
// Instance (plain C entry point, bound with ctypes):
//   stream_read_f32 : v f32, partials f32 (nblocks scratch), out f32 (one value)
// It launches both passes on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() of the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;  // pass 2 reduces at most this many partials

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum of one value a thread over the CTA, valid in thread 0
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float ws[kWarps];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x < 32) {
    s = threadIdx.x < kWarps ? ws[threadIdx.x] : 0.0f;
    s = warp_sum(s);
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
stream_read_pass1(const float* __restrict__ v, float* __restrict__ partials, int64_t N) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const int64_t n4 = N / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (; e + 3 * stride < n4; e += 4 * stride) {
    const float4 p = __ldcs(v4 + e);
    const float4 q = __ldcs(v4 + e + stride);
    const float4 r = __ldcs(v4 + e + 2 * stride);
    const float4 s = __ldcs(v4 + e + 3 * stride);
    a0 += (p.x + p.y) + (p.z + p.w);
    a1 += (q.x + q.y) + (q.z + q.w);
    a2 += (r.x + r.y) + (r.z + r.w);
    a3 += (s.x + s.y) + (s.z + s.w);
  }
  for (; e < n4; e += stride) {
    const float4 p = __ldcs(v4 + e);
    a0 += (p.x + p.y) + (p.z + p.w);
  }
  if (blockIdx.x == 0 && threadIdx.x < N - n4 * 4) a1 += v[n4 * 4 + threadIdx.x];
  const float s = block_sum((a0 + a1) + (a2 + a3));
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kMaxBlocks)
stream_read_pass2(const float* __restrict__ partials, float* __restrict__ out, int nblocks) {
  __shared__ float ws[kMaxBlocks / 32];
  float v = threadIdx.x < nblocks ? partials[threadIdx.x] : 0.0f;
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = ws[threadIdx.x];
    s = warp_sum(s);
    if (threadIdx.x == 0) out[0] = s;
  }
}

}  // namespace

extern "C" {

int stream_read_f32(const void* v, void* partials, void* out, int64_t N, int64_t nblocks, void* stream) {
  if (nblocks < 1 || nblocks > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  stream_read_pass1<<<static_cast<unsigned>(nblocks), kThreads, 0, st>>>(
      static_cast<const float*>(v), static_cast<float*>(partials), N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_read_pass2<<<1, kMaxBlocks, 0, st>>>(static_cast<const float*>(partials), static_cast<float*>(out),
                                              static_cast<int>(nblocks));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
