// LayerNorm and RMSNorm over the last dim, bf16 in and out, fp32 moments.
//
// Replaces anyref_tpu/ops/flash.py layer_norm_fused (_ln_kernel) and
// rms_norm_fused (_rms_kernel). On the TPU they were one VMEM-resident pass
// over 256-row blocks.
//
// Bound on the H100: device-memory bytes. Each row is read once and written
// once (2 * rows * C * 2 bytes); the arithmetic is a few fp32 operations per
// element, far below the card's rate. At the main shapes that is 21 MB for
// the RMSNorm (the LLaMA-7B prefill's [1280, 4096], 0.0063 ms at 3.35 TB/s)
// and 50 / 42 MB for the LayerNorm (SAM-H's [9800, 1280] and [8192, 1280],
// 0.0150 / 0.0125 ms): a few microseconds, so a kernel there is held by
// latency (the launch, one memory round trip) as much as by bandwidth.
//
// One kernel template serves both (row_norm<LAYER>): a row is read once,
// with 16-byte loads where C % 8 == 0 (else element by element), into the
// registers of a team of threads (whole warps); the moments are reduced
// from registers (warp shuffles, plus one shared-memory step across the
// team's warps where a team spans more than one); the output is one pass of
// 16-byte stores. LAYER computes the two-pass moments of the reference
// (mean, then the mean of squared deviations, each its own reduction) and
// adds the bias; RMSNorm the mean of squares. A block holds one team of 128
// threads or more, or 128 / team rows of narrower teams. Scale and bias are
// read in their own dtype (bf16 or fp32, both the same) and converted in
// registers: the wrappers launch this one kernel and nothing else.
//
// One more instance is the LayerNorm row pass of the fused SAM layers
// (anyref_layer_norm_rows, before the GEMMs of gemm.cuh): x bf16 or fp32
// (the fp32 residual x1 of fused_window_block and fused_global_tail),
// always 16-byte chunks, and the window pad mask of the row, so that it
// writes h = bf16(((x - mean) * rstd * scale + bias) * keep) as the TPU
// kernels compute h (anyref_tpu/ops/flash.py:964-972, :1088-1094,
// :1196-1200). Bound: bytes, [9800, 1280] bf16 in and out 50 MB, 0.015 ms.
#include "common.cuh"

// The window pad mask of row m (ws > 0; ws = 0: no mask): row m is token
// m % L of window m / L, windows scan row-major over the padded grid, nwc a
// row, nw an image, and the token is kept where it lies inside the H x W
// grid (ops/flash.py window_pad_mask).
struct RowMask {
  int L, nw, nwc, ws, H, W;
};

__device__ __forceinline__ float keep_row(const RowMask& k, int m) {
  if (k.ws <= 0) return 1.f;
  const int w = (m / k.L) % k.nw, li = m % k.L;
  const int row = (w / k.nwc) * k.ws + li / k.ws;
  const int col = (w % k.nwc) * k.ws + li % k.ws;
  return (row < k.H && col < k.W) ? 1.f : 0.f;
}

// Rows [rows, C] of x (T: bf16, or fp32 with VEC), each held by a team of
// `team` threads (a multiple of 32; blockDim.x / team rows a block), NV
// groups a thread: chunks of 8 columns (VEC: one 16-byte load of bf16, two
// of fp32) or single columns. Group k of team thread u covers columns
// (u + k * team) * G .. + G - 1. bias is read only by LAYER; the output
// row is multiplied by its pad mask (1 where mask.ws = 0).
template <bool LAYER, bool VEC, int NV, typename T>
__global__ void row_norm(const T* __restrict__ x, const void* __restrict__ scale,
                         const void* __restrict__ bias, int w_f32, bf16* __restrict__ y,
                         int rows, int C, int team, float eps, RowMask mask) {
  constexpr int G = VEC ? 8 : 1, Q = sizeof(T) / 2;  // Q: 16-byte loads a chunk
  __shared__ float red[2][32];  // one array a reduction: no barrier between them
  const int tid = threadIdx.x, u = tid % team;
  const int row = blockIdx.x * (blockDim.x / team) + tid / team;
  const bool live = row < rows;
  const size_t off = (size_t)min(row, rows - 1) * C;
  // the sum of v over the team (every thread gets it)
  auto team_sum = [&](float v, float* r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (team > 32) {  // one step across the team's warps
      const int first = (tid - u) >> 5;
      if ((tid & 31) == 0) r[tid >> 5] = v;
      __syncthreads();
      v = 0.f;
      for (int i = 0; i < team / 32; ++i) v += r[first + i];
    }
    return v;
  };

  // every load of the row issued before any is used; the values stay in
  // x's dtype in registers (0 past C) and are converted where they are used
  uint4 raw[VEC ? NV * Q : 1];
  T one[VEC ? 1 : NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = (u + k * team) * G;
    if constexpr (VEC) {
#pragma unroll
      for (int e = 0; e < Q; ++e)
        raw[k * Q + e] = c < C ? *reinterpret_cast<const uint4*>(x + off + c + e * 8 / Q)
                               : make_uint4(0, 0, 0, 0);
    } else {
      one[k] = c < C ? x[off + c] : T(0.f);
    }
  }
  // column j of group k, fp32
  auto val = [&](int k, int j) {
    if constexpr (Q == 2) {
      if constexpr (VEC) return reinterpret_cast<const float*>(&raw[k * Q])[j];
      else return (float)one[k];
    } else {
      if constexpr (VEC) return __bfloat162float(reinterpret_cast<const bf16*>(&raw[k])[j]);
      else return __bfloat162float(one[k]);
    }
  };
  float mean = 0.f;
  if constexpr (LAYER) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
      for (int j = 0; j < G; ++j) s += val(k, j);
    }
    mean = team_sum(s, red[0]) / (float)C;
  }
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    // groups past C hold 0, which is not 0 - mean
    if (LAYER && (u + k * team) * G >= C) break;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float d = val(k, j) - mean;
      q += d * d;
    }
  }
  const float r = rsqrtf(team_sum(q, red[1]) / (float)C + eps);
  if (!live) return;
  const float keep = keep_row(mask, row);
  const float* sf = static_cast<const float*>(scale);
  const bf16* sb = static_cast<const bf16*>(scale);
  const float* bf = static_cast<const float*>(bias);
  const bf16* bb = static_cast<const bf16*>(bias);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = (u + k * team) * G;
    if (c >= C) break;
    float s8[G], b8[G], o8[G];
    if constexpr (VEC) {
      if (w_f32) load8f(sf + c, s8);
      else load8(sb + c, s8);
      if constexpr (LAYER) {
        if (w_f32) load8f(bf + c, b8);
        else load8(bb + c, b8);
      }
    } else {
      s8[0] = w_f32 ? sf[c] : __bfloat162float(sb[c]);
      if constexpr (LAYER) b8[0] = w_f32 ? bf[c] : __bfloat162float(bb[c]);
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if constexpr (LAYER) o8[j] = ((val(k, j) - mean) * r * s8[j] + b8[j]) * keep;
      else o8[j] = val(k, j) * r * s8[j] * keep;
    }
    if constexpr (VEC) store8(y + off + c, o8);
    else y[off + c] = __float2bfloat16(o8[0]);
  }
}

template <bool LAYER, bool VEC, int NV, typename T>
static int launch_row_norm(const void* x, const void* scale, const void* bias, int w_f32, void* y,
                           int rows, int C, int team, float eps, const RowMask& mask,
                           cudaStream_t st) {
  const int rows_a_block = team < 128 ? 128 / team : 1;
  const int blocks = (rows + rows_a_block - 1) / rows_a_block;
  row_norm<LAYER, VEC, NV, T><<<blocks, team * rows_a_block, 0, st>>>(
      (const T*)x, scale, bias, w_f32, (bf16*)y, rows, C, team, eps, mask);
  return (int)cudaGetLastError();
}

// The team and the groups a thread for rows of `cols`, then the instance:
// one warp a row up to 8 groups a lane (no shared step and no barrier; at
// SAM-H's [9800, 1280], five 16-byte chunks a lane, faster on the H100 than
// two warps of four), else teams of whole warps with about 4 groups a thread
// (at the LLaMA-7B prefill's [1280, 4096] faster than one warp of 16 chunks
// a row, or 512 threads of 1); NV = 1 .. 8 or 16 groups a thread. fp32 x
// is read in chunks only (vec).
template <bool LAYER, typename T = bf16>
static int row_norm_entry(const void* x, const void* scale, const void* bias, int w_f32, void* y,
                          int rows, int cols, float eps, int vec, void* stream,
                          const RowMask& mask = RowMask{0, 0, 0, 0, 0, 0}) {
  if (rows <= 0 || cols <= 0) return 0;
  if (sizeof(T) == 4 && !vec) return (int)cudaErrorInvalidValue;
  if (mask.ws > 0 && (mask.L <= 0 || mask.nw <= 0 || mask.nwc <= 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int groups = vec ? cols / 8 : cols;
  if (groups > 1024 * 16) return (int)cudaErrorInvalidValue;
  const int team = groups <= 32 * 8 ? 32 : min(1024, ((groups + 3) / 4 + 31) / 32 * 32);
  int nv = (groups + team - 1) / team;
  if (nv > 8) nv = 16;
#define ANYREF_NORM(V, N) \
  case N:                 \
    return launch_row_norm<LAYER, V, N, T>(x, scale, bias, w_f32, y, rows, cols, team, eps, \
                                           mask, st);
#define ANYREF_NORMS(V)                                                                     \
  switch (nv) {                                                                             \
    ANYREF_NORM(V, 1) ANYREF_NORM(V, 2) ANYREF_NORM(V, 3) ANYREF_NORM(V, 4) ANYREF_NORM(V, 5) \
    ANYREF_NORM(V, 6) ANYREF_NORM(V, 7) ANYREF_NORM(V, 8) ANYREF_NORM(V, 16)                 \
  }
  if (vec) {
    ANYREF_NORMS(true)
  } else if constexpr (sizeof(T) == 2) {
    ANYREF_NORMS(false)
  }
#undef ANYREF_NORMS
#undef ANYREF_NORM
  return (int)cudaErrorInvalidValue;
}

// x, y [rows, cols] bf16; scale and bias [cols], both bf16 or both fp32
// (w_f32). vec: x, y, scale and bias 16-byte aligned and cols % 8 == 0.
// Rows of up to 131,072 columns (vec) or 16,384 (not vec).
ANYREF_API int anyref_layer_norm(const void* x, const void* scale, const void* bias, int w_f32,
                                 void* y, int rows, int cols, float eps, int vec, void* stream) {
  return row_norm_entry<true>(x, scale, bias, w_f32, y, rows, cols, eps, vec, stream);
}

// As anyref_layer_norm, without the bias: scale [cols] bf16 or fp32
// (scale_f32).
ANYREF_API int anyref_rms_norm(const void* x, const void* scale, int scale_f32, void* y,
                               int rows, int cols, float eps, int vec, void* stream) {
  return row_norm_entry<false>(x, scale, nullptr, scale_f32, y, rows, cols, eps, vec, stream);
}

// The LayerNorm row pass of the fused SAM layers: y = bf16(LayerNorm(x) *
// keep) over x [rows, cols] bf16 or (x_f32) fp32, scale and bias [cols]
// both bf16 or both fp32 (w_f32), keep the window pad mask of each row
// (ws > 0: win_L tokens a window, win_nw windows an image, win_nwc a row
// of the padded grid, the grid_h x grid_w grid inside it; ws = 0: no
// mask). cols % 8 == 0 and every pointer 16-byte aligned.
ANYREF_API int anyref_layer_norm_rows(const void* x, int x_f32, const void* scale,
                                      const void* bias, int w_f32, void* y, int rows, int cols,
                                      float eps, int win_L, int win_nw, int win_nwc, int ws,
                                      int grid_h, int grid_w, void* stream) {
  if (cols % 8) return (int)cudaErrorInvalidValue;
  const RowMask mask{win_L, win_nw, win_nwc, ws, grid_h, grid_w};
  if (x_f32)
    return row_norm_entry<true, float>(x, scale, bias, w_f32, y, rows, cols, eps, 1, stream, mask);
  return row_norm_entry<true, bf16>(x, scale, bias, w_f32, y, rows, cols, eps, 1, stream, mask);
}

ANYREF_API const char* anyref_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
