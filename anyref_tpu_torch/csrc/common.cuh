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

// 8 consecutive floats as two 16-byte loads (16-byte aligned).
__device__ __forceinline__ void load8f(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// ---------------------------------------------------------------------------
// PTX helpers of the tensor-core kernels (window_attention.cu, wgmma.cuh)
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy, zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4-byte global -> shared copy (.ca: the .cg form takes 16 bytes only),
// zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D = A (16x16, row) * B (16x8, col) + D, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, as stored / transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// 2^x (MUFU; -inf -> 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
