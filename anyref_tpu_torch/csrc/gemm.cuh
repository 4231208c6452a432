// One templated GEMM for the fused SAM layers: out[M, N] = A[M, K] @ B[K, N]
// with bf16 operands in the tensor cores and fp32 accumulation, an optional
// LayerNorm prologue on A and one of three epilogues.
//
// - A is bf16 [M, K] (copied as it is), or bf16 / fp32 [M, K] normalised on
//   the way into shared memory: h = ((a - mean) * rstd * scale + bias) *
//   keep, rounded to bf16 before the product, with the row moments (fp32,
//   over the whole row) from anyref_row_stats and `keep` the window pad
//   mask of the row (1 where no mask is asked for). This is where the TPU
//   kernels round h (anyref_tpu/ops/flash.py:967-972, :1088-1094,
//   :1196-1200).
// - B is a bf16 weight [K, N], row-major as the parameter tree stores it.
// - Epilogues on the fp32 sum: + bias -> bf16; + bias -> exact GELU ->
//   bf16; + bias + residual (bf16 or fp32) -> bf16 or fp32.
//
// What bounds it on the H100: tensor-core operations (2 M N K) at the SAM
// shapes (M 9800 / 8192, N and K 1280..5120: ~1000 operations per byte).
// The design is the plain one of a first version: blocks of 128 x 128
// outputs, eight warps of 64 x 32 in mma.sync.m16n8k16 fragments fed by
// ldmatrix from padded (bank-conflict-free) shared-memory tiles, K walked in
// steps of 32 through a three-stage cp.async ring. A LayerNorm prologue
// loads its A tile through registers instead (the transform has to happen
// before the tile reaches shared memory): the raw A of the tile two steps
// ahead is fetched before this step's products and normalised into shared
// memory after them, so the loads' latency hides behind the products. Rows
// past M and columns past N or K are zero-filled on the way in and not
// stored on the way out; N and K must be multiples of 8.
// No wgmma or TMA yet: that is the next step for speed.
#pragma once

#include "common.cuh"

namespace anyref_mm {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, NTHREADS = 256;
constexpr int LDA = BK + 8;  // 80-byte rows: ldmatrix rows in distinct banks
constexpr int LDB = BN + 8;  // 272-byte rows
enum AMode { A_BF16 = 0, A_LN_BF16 = 1, A_LN_F32 = 2 };
enum Epi { E_BIAS = 0, E_BIAS_GELU = 1, E_BIAS_RES = 2 };

struct Params {
  const void* a;           // [M, K], bf16 or (A_LN_F32) fp32
  const bf16* b;           // [K, N]
  const float* bias;       // [N]
  const void* res;         // [M, N] residual (E_BIAS_RES)
  void* out;               // [M, N]
  int M, N, K;
  const float2* stats;     // [M] (mean, rstd), LayerNorm prologue
  const float* ln_scale;   // [K]
  const float* ln_bias;    // [K]
  // window pad mask (ws > 0): row m is token m % L of window m / L; windows
  // scan row-major over the padded grid, nwc per row, nw per image
  int win_L, win_nw, win_nwc, ws, grid_h, grid_w;
};

constexpr size_t smem_bytes() {
  return (size_t)STAGES * (BM * LDA + BK * LDB) * 2 + 3 * BM * sizeof(float);
}

__device__ __forceinline__ float keep_row(const Params& p, int m) {
  if (p.ws <= 0) return 1.f;
  const int w = (m / p.win_L) % p.win_nw, li = m % p.win_L;
  const int row = (w / p.win_nwc) * p.ws + li / p.ws;
  const int col = (w % p.win_nwc) * p.ws + li % p.ws;
  return (row < p.grid_h && col < p.grid_w) ? 1.f : 0.f;
}

__device__ __forceinline__ float gelu_exact(float x) {
  return x * 0.5f * (1.f + erff(x * 0.70710678118654752f));
}

template <int AMODE, int EPI, bool RES_F32, bool OUT_F32>
__global__ void __launch_bounds__(NTHREADS, 2) gemm_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [STAGES][BM][LDA]
  bf16* Bs = As + STAGES * BM * LDA;          // [STAGES][BK][LDB]
  float* row_mean = reinterpret_cast<float*>(Bs + STAGES * BK * LDB);
  float* row_rstd = row_mean + BM;
  float* row_keep = row_rstd + BM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm * 64, cols wn * 32
  const int g = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int M = p.M, N = p.N, K = p.K;

  if (AMODE != A_BF16) {
    for (int r = tid; r < BM; r += NTHREADS) {
      const int m = m0 + r;
      float mean = 0.f, rstd = 0.f, keep = 0.f;
      if (m < M) {
        const float2 st = p.stats[m];
        mean = st.x;
        rstd = st.y;
        keep = keep_row(p, m);
      }
      row_mean[r] = mean;
      row_rstd[r] = rstd;
      row_keep[r] = keep;
    }
    __syncthreads();
  }

  // B tiles (and plain A tiles) go to shared memory with cp.async
  auto load_async = [&](int st, int kt) {
    const int k0 = kt * BK;
    bf16* as = As + st * BM * LDA;
    bf16* bs = Bs + st * BK * LDB;
    for (int i = tid; i < BK * BN / 8; i += NTHREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async16(bs + r * LDB + c, ok ? p.b + (size_t)(k0 + r) * N + n0 + c : p.b, ok);
    }
    if (AMODE == A_BF16) {
      const bf16* a = static_cast<const bf16*>(p.a);
      for (int i = tid; i < BM * BK / 8; i += NTHREADS) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const int m = m0 + r, k = k0 + c;
        const bool ok = m < M && k < K;
        cp_async16(as + r * LDA + c, ok ? a + (size_t)m * K + k : a, ok);
      }
    }
  };
  // LayerNorm prologue: this thread's A_VECS runs of 8 raw A values of
  // tile kt into registers (fetch), then normalised into shared memory
  // (store)
  constexpr int A_VECS = BM * BK / 8 / NTHREADS;
  uint4 araw[A_VECS][2];
  auto fetch_a = [&](int kt) {
#pragma unroll
    for (int it = 0; it < A_VECS; ++it) {
      const int i = tid + it * NTHREADS, r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int m = m0 + r, k = kt * BK + c;
      araw[it][0] = araw[it][1] = make_uint4(0, 0, 0, 0);
      if (m < M && k < K) {
        if (AMODE == A_LN_BF16) {
          araw[it][0] = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.a) +
                                                         (size_t)m * K + k);
        } else {
          const uint4* src = reinterpret_cast<const uint4*>(static_cast<const float*>(p.a) +
                                                            (size_t)m * K + k);
          araw[it][0] = src[0];
          araw[it][1] = src[1];
        }
      }
    }
  };
  auto store_a = [&](int st, int kt) {
    bf16* as = As + st * BM * LDA;
#pragma unroll
    for (int it = 0; it < A_VECS; ++it) {
      const int i = tid + it * NTHREADS, r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int m = m0 + r, k = kt * BK + c;
      float v[8];
      if (m < M && k < K) {
        if (AMODE == A_LN_BF16) {
          load8(reinterpret_cast<const bf16*>(&araw[it][0]), v);
        } else {
          const float* f = reinterpret_cast<const float*>(&araw[it][0]);
          const float* f2 = reinterpret_cast<const float*>(&araw[it][1]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[j] = f[j];
            v[4 + j] = f2[j];
          }
        }
        float sc[8], bi[8];
        load8f(p.ln_scale + k, sc);
        load8f(p.ln_bias + k, bi);
        const float mean = row_mean[r], rstd = row_rstd[r], keep = row_keep[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = ((v[j] - mean) * rstd * sc[j] + bi[j]) * keep;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
      store8(as + r * LDA + c, v);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) {
      load_async(s, s);
      if (AMODE != A_BF16) {
        fetch_a(s);
        store_a(s, s);
      }
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed for everyone; stage kt - 1 is free
    const int nk = kt + STAGES - 1;
    if (nk < KT) {
      load_async(nk % STAGES, nk);
      if (AMODE != A_BF16) fetch_a(nk);
    }
    cp_async_commit();

    const bf16* as = As + (kt % STAGES) * BM * LDA;
    const bf16* bs = Bs + (kt % STAGES) * BK * LDB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(af[mt], as + (wm * 64 + mt * 16 + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_trans(bfr[np], bs + (kk + (lane & 15)) * LDB + wn * 32 + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma16816(acc[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2], bfr[nt >> 1][(nt & 1) * 2 + 1]);
    }
    // the A tile of step nk into stage kt - 1, which every warp finished
    // reading before this step's barrier; read after the barrier of step nk
    if (AMODE != A_BF16 && nk < KT) store_a(nk % STAGES, nk);
  }
  cp_async_wait<0>();

  // epilogue: lane holds rows g and g + 8 of each 16 x 8 tile, columns
  // tig * 2 and tig * 2 + 1
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + tig * 2;
      if (col >= N) continue;
      const float b0 = p.bias[col], b1 = p.bias[col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mt * 16 + g + half * 8;
        if (row >= M) continue;
        float v0 = acc[mt][nt][half * 2] + b0, v1 = acc[mt][nt][half * 2 + 1] + b1;
        const size_t off = (size_t)row * N + col;
        if (EPI == E_BIAS_GELU) {
          v0 = gelu_exact(v0);
          v1 = gelu_exact(v1);
        } else if (EPI == E_BIAS_RES) {
          if (RES_F32) {
            const float2 r = *reinterpret_cast<const float2*>(static_cast<const float*>(p.res) + off);
            v0 += r.x;
            v1 += r.y;
          } else {
            const float2 r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(p.res) + off));
            v0 += r.x;
            v1 += r.y;
          }
        }
        if (OUT_F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + off) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <int AMODE, int EPI, bool RES_F32, bool OUT_F32>
inline int launch(const Params& p, void* stream) {
  if (p.M <= 0 || p.N <= 0) return 0;
  if (p.N % 8 || p.K % 8 || p.K <= 0) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(gemm_kernel<AMODE, EPI, RES_F32, OUT_F32>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  gemm_kernel<AMODE, EPI, RES_F32, OUT_F32><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Row moments for the LayerNorm prologue: stats[m] = (mean, rsqrt(var +
// eps)) of row m of x [M, K] (bf16 or fp32), fp32, two passes (the mean,
// then the mean of squared deviations), one warp per row, 16-byte loads.
template <typename T>
__global__ void __launch_bounds__(256) row_stats_kernel(const T* __restrict__ x,
                                                        float2* __restrict__ stats, int M, int K,
                                                        float eps) {
  const int m = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (m >= M) return;
  const T* xr = x + (size_t)m * K;
  auto load = [&](int k, float* v) {
    if constexpr (sizeof(T) == 2) load8(reinterpret_cast<const bf16*>(xr) + k, v);
    else load8f(reinterpret_cast<const float*>(xr) + k, v);
  };
  float s = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    float v[8];
    load(k, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += v[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mean = s / (float)K;
  float q = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    float v[8];
    load(k, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = v[j] - mean;
      q += d * d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
  if (lane == 0) stats[m] = make_float2(mean, rsqrtf(q / (float)K + eps));
}

}  // namespace anyref_mm
