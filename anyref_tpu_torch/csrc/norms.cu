// LayerNorm and RMSNorm over the last dim, bf16 in and out, fp32 moments.
//
// Replaces anyref_tpu/ops/flash.py layer_norm_fused (_ln_kernel) and
// rms_norm_fused (_rms_kernel). On the TPU they were one VMEM-resident pass
// over 256-row blocks.
//
// Bound on the H100: device-memory bytes. Each row is read once and written
// once (2 * rows * C * 2 bytes); the arithmetic is a few fp32 operations per
// element, far below the card's rate.
//
// Design: one block per row. The row is read from device memory once, with
// 16-byte vector loads (8 bf16) where C % 8 == 0, and kept in shared memory as
// fp32, so the two-pass moments (mean, then mean of squared deviations, as
// the reference computes them) and the output pass read no device memory
// again. Reductions are warp shuffles plus one shared-memory step across
// warps. Scale and bias arrive as fp32 (the wrapper upcasts them, as the
// reference does inside its kernel).
#include "common.cuh"

template <bool LAYER>
__global__ void norm_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                            const float* __restrict__ bias, bf16* __restrict__ y, int C,
                            float eps, int vec) {
  extern __shared__ float smem[];
  float* row = smem;     // C floats
  float* red = smem + C; // 32 floats for block_sum
  const size_t off = (size_t)blockIdx.x * C;
  const bf16* xr = x + off;
  bf16* yr = y + off;
  const int t = threadIdx.x, nt = blockDim.x;

  // Every pass walks the same elements per thread, so a thread only reads
  // back what it wrote itself: no barrier is needed between passes beyond
  // the ones inside block_sum.
  float s = 0.f;
  if (vec) {
    for (int i = t * 8; i < C; i += nt * 8) {
      float v[8];
      load8(xr + i, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        row[i + j] = v[j];
        s += v[j];
      }
    }
  } else {
    for (int i = t; i < C; i += nt) {
      const float v = __bfloat162float(xr[i]);
      row[i] = v;
      s += v;
    }
  }
  float mean = 0.f;
  if (LAYER) mean = block_sum(s, red) / (float)C;

  float q = 0.f;
  if (vec) {
    for (int i = t * 8; i < C; i += nt * 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = row[i + j] - mean;
        q += d * d;
      }
    }
  } else {
    for (int i = t; i < C; i += nt) {
      const float d = row[i] - mean;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(block_sum(q, red) / (float)C + eps);

  if (vec) {
    for (int i = t * 8; i < C; i += nt * 8) {
      float s8[8], b8[8], o[8];
      load8f(scale + i, s8);
      if (LAYER) load8f(bias + i, b8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = (row[i + j] - mean) * rstd;
        o[j] = LAYER ? v * s8[j] + b8[j] : v * s8[j];
      }
      store8(yr + i, o);
    }
  } else {
    for (int i = t; i < C; i += nt) {
      const float v = (row[i] - mean) * rstd;
      yr[i] = __float2bfloat16(LAYER ? v * scale[i] + bias[i] : v * scale[i]);
    }
  }
}

template <bool LAYER>
static int launch_norm(const void* x, const void* scale, const void* bias, void* y, int rows,
                       int cols, float eps, int vec, void* stream) {
  if (rows <= 0) return 0;
  const int per_thread = vec ? 8 : 1;
  int threads = (cols + per_thread - 1) / per_thread;
  threads = ((threads + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  const size_t smem = (size_t)(cols + 32) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(norm_kernel<LAYER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  norm_kernel<LAYER><<<rows, threads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)scale, (const float*)bias, (bf16*)y, cols, eps, vec);
  return (int)cudaGetLastError();
}

ANYREF_API int anyref_layer_norm(const void* x, const void* scale, const void* bias, void* y,
                                 int rows, int cols, float eps, int vec, void* stream) {
  return launch_norm<true>(x, scale, bias, y, rows, cols, eps, vec, stream);
}

ANYREF_API int anyref_rms_norm(const void* x, const void* scale, void* y, int rows, int cols,
                               float eps, int vec, void* stream) {
  return launch_norm<false>(x, scale, nullptr, y, rows, cols, eps, vec, stream);
}

ANYREF_API const char* anyref_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
