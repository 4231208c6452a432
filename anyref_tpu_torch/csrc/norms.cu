// LayerNorm and RMSNorm over the last dim, bf16 in and out, fp32 moments.
//
// Replaces anyref_tpu/ops/flash.py layer_norm_fused (_ln_kernel) and
// rms_norm_fused (_rms_kernel). On the TPU they were one VMEM-resident pass
// over 256-row blocks.
//
// Bound on the H100: device-memory bytes. Each row is read once and written
// once (2 * rows * C * 2 bytes); the arithmetic is a few fp32 operations per
// element, far below the card's rate. At the RMSNorm's main shape, the
// LLaMA-7B prefill's [1280, 4096], that is 21 MB, 0.0063 ms at 3.35 TB/s:
// the time of a launch, so a kernel there is held by latency, not by
// bandwidth.
//
// LayerNorm (norm_kernel<true>): one block per row. The row is read from
// device memory once, with 16-byte vector loads (8 bf16) where C % 8 == 0,
// and kept in shared memory as fp32, so the two-pass moments (mean, then
// mean of squared deviations, as the reference computes them) and the
// output pass read no device memory again. Reductions are warp shuffles
// plus one shared-memory step across warps. Scale and bias arrive as fp32
// (the wrapper upcasts them, as the reference does inside its kernel).
//
// RMSNorm (rms_kernel): a row is read once, with 16-byte loads where C % 8
// == 0 (else element by element), into the registers of a team of threads
// (whole warps, about four 16-byte chunks a thread: 128 threads at C =
// 4096); the mean of squares is one warp-shuffle reduction plus one
// shared-memory step across the team's warps; the output is one pass of
// 16-byte stores. A block holds one team of 128 threads or more, or 128 /
// team rows of narrower teams, so [1280, 4096] is 1280 blocks of 4 warps,
// ~10 a SM in flight at once on 132 SMs. The scale is
// read in its own dtype (bf16 or fp32) and converted in registers: the
// wrapper launches this one kernel and nothing else.
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

// RMSNorm of rows [rows, C], the row held in registers by a team of `team`
// threads (a multiple of 32; blockDim.x / team rows a block), NV groups a
// thread: 16-byte chunks of 8 columns (VEC) or single columns. Group k of
// team thread u covers columns (u + k * team) * G .. + G - 1.
template <bool VEC, int NV>
__global__ void rms_kernel(const bf16* __restrict__ x, const void* __restrict__ scale,
                           int scale_f32, bf16* __restrict__ y, int rows, int C, int team,
                           float eps) {
  constexpr int G = VEC ? 8 : 1;
  __shared__ float red[32];
  const int tid = threadIdx.x, u = tid % team;
  const int row = blockIdx.x * (blockDim.x / team) + tid / team;
  const bool live = row < rows;
  const size_t off = (size_t)min(row, rows - 1) * C;
  uint4 raw[VEC ? NV : 1];
  bf16 one[VEC ? 1 : NV];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = (u + k * team) * G;
    if constexpr (VEC) {
      raw[k] = c < C ? *reinterpret_cast<const uint4*>(x + off + c) : make_uint4(0, 0, 0, 0);
    } else {
      one[k] = c < C ? x[off + c] : __float2bfloat16(0.f);
    }
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if constexpr (VEC) {
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw[k]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        ss += f.x * f.x + f.y * f.y;
      }
    } else {
      const float f = __bfloat162float(one[k]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (team > 32) {  // one step across the team's warps
    const int warp = tid >> 5, first = (tid - u) >> 5;
    if ((tid & 31) == 0) red[warp] = ss;
    __syncthreads();
    ss = 0.f;
    for (int i = 0; i < team / 32; ++i) ss += red[first + i];
  }
  const float r = rsqrtf(ss / (float)C + eps);
  if (!live) return;
  const float* sf = static_cast<const float*>(scale);
  const bf16* sb = static_cast<const bf16*>(scale);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = (u + k * team) * G;
    if (c >= C) break;
    if constexpr (VEC) {
      float s8[8], o8[8];
      if (scale_f32) load8f(sf + c, s8);
      else load8(sb + c, s8);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw[k]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        o8[2 * j] = f.x * r * s8[2 * j];
        o8[2 * j + 1] = f.y * r * s8[2 * j + 1];
      }
      store8(y + off + c, o8);
    } else {
      const float s1 = scale_f32 ? sf[c] : __bfloat162float(sb[c]);
      y[off + c] = __float2bfloat16(__bfloat162float(one[k]) * r * s1);
    }
  }
}

template <bool VEC, int NV>
static int launch_rms(const void* x, const void* scale, int scale_f32, void* y, int rows, int C,
                      int team, float eps, cudaStream_t st) {
  const int rows_a_block = team < 128 ? 128 / team : 1;
  const int blocks = (rows + rows_a_block - 1) / rows_a_block;
  rms_kernel<VEC, NV><<<blocks, team * rows_a_block, 0, st>>>(
      (const bf16*)x, scale, scale_f32, (bf16*)y, rows, C, team, eps);
  return (int)cudaGetLastError();
}

// x, y [rows, cols] bf16; scale [cols] bf16 or fp32 (scale_f32). vec: x, y
// and scale 16-byte aligned and cols % 8 == 0. Rows of up to 131,072
// columns (vec) or 16,384 (not vec).
ANYREF_API int anyref_rms_norm(const void* x, const void* scale, int scale_f32, void* y,
                               int rows, int cols, float eps, int vec, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int groups = vec ? cols / 8 : cols;
  if (groups > 1024 * 16) return (int)cudaErrorInvalidValue;
  // teams of whole warps, about 4 groups a thread (at [1280, 4096] on the
  // H100 faster than one warp of 16 chunks a row, or 512 threads of 1),
  // NV = 1 .. 16 groups a thread
  const int team = min(1024, max(32, ((groups + 3) / 4 + 31) / 32 * 32));
  int nv = 1;
  while (nv < 16 && team * nv < groups) nv *= 2;
#define ANYREF_RMS(V, N) \
  case N:                \
    return launch_rms<V, N>(x, scale, scale_f32, y, rows, cols, team, eps, st);
  if (vec) {
    switch (nv) { ANYREF_RMS(true, 1) ANYREF_RMS(true, 2) ANYREF_RMS(true, 4)
                  ANYREF_RMS(true, 8) ANYREF_RMS(true, 16) }
  } else {
    switch (nv) { ANYREF_RMS(false, 1) ANYREF_RMS(false, 2) ANYREF_RMS(false, 4)
                  ANYREF_RMS(false, 8) ANYREF_RMS(false, 16) }
  }
#undef ANYREF_RMS
  return (int)cudaErrorInvalidValue;
}

ANYREF_API const char* anyref_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
