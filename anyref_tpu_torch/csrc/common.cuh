// Shared helpers for the anyref_tpu_torch kernels (plain C ABI, loaded with
// ctypes by anyref_tpu_torch/ops/flash.py). Every entry point launches on the
// stream it is given, never synchronises, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define ANYREF_API extern "C" __attribute__((visibility("default")))

// Sum over the whole block; every thread gets the total. blockDim.x must be a
// multiple of 32 and at most 1024; `red` holds 32 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // an earlier call may still be reading `red`
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  float t = lane < nwarps ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

// 16-byte vector of 8 bf16 <-> 8 floats.
__device__ __forceinline__ void load8(const bf16* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float* in) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(in[2 * j], in[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}
