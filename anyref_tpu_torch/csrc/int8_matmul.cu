// Weight-only int8 matmul: out[M, N] = bf16((x[M, K] @ w_q[K, N]) * scale[N])
// with x bf16, w_q int8 row-major [K, N] as quantize_llama stores it and
// scale fp32 per output column. Replaces anyref_tpu/ops/quant.py
// int8_matmul (_kernel): each weight is converted to bf16 (exact: |w| <=
// 127), multiplied by bf16 x and summed in fp32 over the whole K; the
// column scale is applied ONCE to that sum, and only then is the result
// rounded to bf16. Dequantising a tile to bf16(w * scale) first would round
// differently and is not this function.
//
// The launcher picks one of two bodies by M:
//
// * M <= 16 (a decode step: M = batch). Bound by the weight bytes (K * N,
//   ~4.4 operations a byte at M = 2, far below the ~295 where the tensor
//   cores become the limit): 5.0 us for 4096 x 4096 and 13.5 us for 4096 x
//   11008 at 3.35 TB/s. The design streams W once, row-major, with 16-byte
//   loads along N (8-byte where N % 16 != 0): a warp reads 512 contiguous
//   bytes of one row, a block of 8 warps 128 rows of a 512-column slab,
//   four rows in flight per thread (all sixteen up front measured slower:
//   128 registers, fewer blocks per SM). x's rows of the block's K range
//   sit in shared memory as fp32. The int8 -> fp32 conversion is a byte
//   permute into the mantissa of 2^23 and one subtraction (no I2F, whose
//   rate is close to the memory's byte rate). K is split across blocks
//   (128 rows each) so that N = 4096 still fills the 132 SMs (8 slabs x
//   32 splits);
//   each block writes its fp32 partial sums to a workspace [splits, M, N],
//   and a second kernel sums the splits in a fixed order, scales and
//   rounds. No atomics: the result is the same from run to run.
// * M > 16 (prefill, M = 1280 at batch 2). Bound by tensor-core operations
//   (2 M N K: 42.9 GFLOP at 1280 x 4096 x 4096, 0.043 ms at 989 TFLOP/s).
//   The mma.sync tiles of gemm.cuh (128 x 128 blocks, eight warps of 64 x
//   32, K steps of 32 through a three-stage cp.async ring) with B copied as
//   int8 (16 weights per 16-byte copy) and converted to bf16 into the
//   padded shared tile that ldmatrix reads; the scale is the epilogue.
//
// K and N must be multiples of 8 and x and w_q 16-byte aligned.
#include "common.cuh"

namespace anyref_i8 {

// 4 int8 in a 32-bit word -> 4 exact floats: (v ^ 0x80) = v + 128 placed in
// the low mantissa byte of 2^23, minus 2^23 + 128.
__device__ __forceinline__ void i8x4_to_f32(uint32_t u, float* f) {
  const uint32_t b = u ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7543)) - 8388736.f;
}

// ---------------------------------------------------------------------------
// M <= 16: split-K streaming kernel and the split reduction
// ---------------------------------------------------------------------------
constexpr int GV_THREADS = 256, GV_WARPS = 8;
constexpr int GV_COLS = 512;                // 32 lanes x 16 columns
constexpr int GV_RPW = 16;                  // K rows per warp
constexpr int GV_KC = GV_WARPS * GV_RPW;    // K rows per block
constexpr int GV_UNROLL = 4;                // rows in flight per thread
constexpr int GV_MAX_M = 16;

inline int gv_splits(int K) { return (K + GV_KC - 1) / GV_KC; }

// Rows [m0, m0 + MT) of x times this block's 128-row, 512-column tile of W
// -> ws[split][m][n] (fp32 partial sums over the block's K range).
template <int MT, bool VEC16>
__global__ void __launch_bounds__(GV_THREADS) gemv_kernel(const bf16* __restrict__ x,
                                                          const int8_t* __restrict__ w,
                                                          float* __restrict__ ws, int M, int N,
                                                          int K) {
  __shared__ float xs[MT][GV_KC];
  __shared__ float red[GV_WARPS][GV_COLS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * GV_COLS, k0 = blockIdx.y * GV_KC, m0 = blockIdx.z * MT;
  const int n = n0 + lane * 16;  // this thread's 16 columns
  for (int i = threadIdx.x; i < MT * GV_KC; i += GV_THREADS) {
    const int m = i / GV_KC, k = i % GV_KC;
    xs[m][k] = (m0 + m < M && k0 + k < K) ? __bfloat162float(x[(size_t)(m0 + m) * K + k0 + k])
                                          : 0.f;
  }
  __syncthreads();

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

  // N % 8 == 0, so the upper 8 columns are all in or all out
  const bool lo = n < N, hi = n + 8 < N;
  if (lo) {
#pragma unroll
    for (int r0 = 0; r0 < GV_RPW; r0 += GV_UNROLL) {
      uint4 raw[GV_UNROLL];
#pragma unroll
      for (int u = 0; u < GV_UNROLL; ++u) {
        const int k = k0 + warp * GV_RPW + r0 + u;
        raw[u] = make_uint4(0, 0, 0, 0);
        if (k < K) {
          const int8_t* src = w + (size_t)k * N + n;
          if (VEC16) {
            raw[u] = __ldg(reinterpret_cast<const uint4*>(src));
          } else {
            const uint2 a = __ldg(reinterpret_cast<const uint2*>(src));
            raw[u].x = a.x;
            raw[u].y = a.y;
            if (hi) {
              const uint2 b = __ldg(reinterpret_cast<const uint2*>(src + 8));
              raw[u].z = b.x;
              raw[u].w = b.y;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < GV_UNROLL; ++u) {
        float wf[16];
        i8x4_to_f32(raw[u].x, wf);
        i8x4_to_f32(raw[u].y, wf + 4);
        i8x4_to_f32(raw[u].z, wf + 8);
        i8x4_to_f32(raw[u].w, wf + 12);
        const int kl = warp * GV_RPW + r0 + u;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[m][kl];
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[m][j] = fmaf(xv, wf[j], acc[m][j]);
        }
      }
    }
  }

  // sum the 8 warps' partials in a fixed order, one row of x at a time
  float* out = ws + (size_t)blockIdx.y * M * N;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int j = 0; j < 16; ++j) red[warp][lane * 16 + j] = acc[m][j];
    __syncthreads();
    for (int c = threadIdx.x; c < GV_COLS; c += GV_THREADS) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < GV_WARPS; ++wi) s += red[wi][c];
      if (m0 + m < M && n0 + c < N) out[(size_t)(m0 + m) * N + n0 + c] = s;
    }
    __syncthreads();
  }
}

// out[m, n] = bf16(scale[n] * sum over splits s = 0.. of ws[s, m, n])
__global__ void __launch_bounds__(256) reduce_kernel(const float* __restrict__ ws,
                                                     const float* __restrict__ scale,
                                                     bf16* __restrict__ out, int M, int N,
                                                     int S) {
  const size_t MN = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += ws[(size_t)k * MN + i];
  out[i] = __float2bfloat16(s * scale[i % N]);
}

template <int MT>
int launch_gemv(const bf16* x, const int8_t* w, const float* scale, bf16* out, float* ws, int M,
                int N, int K, cudaStream_t st) {
  const int S = gv_splits(K);
  const dim3 grid((N + GV_COLS - 1) / GV_COLS, S, (M + MT - 1) / MT);
  if (N % 16 == 0)
    gemv_kernel<MT, true><<<grid, GV_THREADS, 0, st>>>(x, w, ws, M, N, K);
  else
    gemv_kernel<MT, false><<<grid, GV_THREADS, 0, st>>>(x, w, ws, M, N, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t MN = (size_t)M * N;
  reduce_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(ws, scale, out, M, N, S);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// M > 16: tensor-core GEMM with int8 B
// ---------------------------------------------------------------------------
constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, NTHREADS = 256;
constexpr int LDA = BK + 8;  // 80-byte rows: ldmatrix rows in distinct banks
constexpr int LDB = BN + 8;  // 272-byte rows

constexpr size_t gemm_smem_bytes() {
  return (size_t)STAGES * BM * LDA * 2 + (size_t)STAGES * BK * BN + (size_t)BK * LDB * 2;
}

// 8-byte global -> shared copy (.ca: the .cg form takes 16 bytes only),
// zero-filled when !valid.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 8 : 0));
}

template <bool VEC16>
__global__ void __launch_bounds__(NTHREADS, 2) gemm_kernel(const bf16* __restrict__ a,
                                                           const int8_t* __restrict__ b,
                                                           const float* __restrict__ scale,
                                                           bf16* __restrict__ out, int M, int N,
                                                           int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);                  // [STAGES][BM][LDA]
  int8_t* Bq = reinterpret_cast<int8_t*>(As + STAGES * BM * LDA);  // [STAGES][BK][BN]
  bf16* Bs = reinterpret_cast<bf16*>(Bq + STAGES * BK * BN);  // [BK][LDB]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm * 64, cols wn * 32
  const int g = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  auto load_async = [&](int st, int kt) {
    const int k0 = kt * BK;
    int8_t* bq = Bq + st * BK * BN;
    constexpr int CW = VEC16 ? 16 : 8;  // weights per copy
    for (int i = tid; i < BK * BN / CW; i += NTHREADS) {
      const int r = i / (BN / CW), c = (i % (BN / CW)) * CW;
      const bool ok = k0 + r < K && n0 + c < N;
      const int8_t* src = ok ? b + (size_t)(k0 + r) * N + n0 + c : b;
      if (VEC16) cp_async16(bq + r * BN + c, src, ok);
      else cp_async8(bq + r * BN + c, src, ok);
    }
    bf16* as = As + st * BM * LDA;
    for (int i = tid; i < BM * BK / 8; i += NTHREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int m = m0 + r, k = k0 + c;
      const bool ok = m < M && k < K;
      cp_async16(as + r * LDA + c, ok ? a + (size_t)m * K + k : a, ok);
    }
  };
  // the int8 tile of stage st -> bf16 Bs (16 weights a thread)
  auto convert = [&](int st) {
    const int8_t* bq = Bq + st * BK * BN;
    const int r = tid / (BN / 16), c = (tid % (BN / 16)) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(bq + r * BN + c);
    float f[16];
    i8x4_to_f32(raw.x, f);
    i8x4_to_f32(raw.y, f + 4);
    i8x4_to_f32(raw.z, f + 8);
    i8x4_to_f32(raw.w, f + 12);
    store8(Bs + r * LDB + c, f);
    store8(Bs + r * LDB + c + 8, f + 8);
  };
  static_assert(BK * BN / 16 == NTHREADS, "one 16-weight run per thread");

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_async(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed for everyone; Bs and stage kt - 1 are free
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_async(nk % STAGES, nk);
    cp_async_commit();
    convert(kt % STAGES);
    __syncthreads();  // Bs holds step kt's weights in bf16

    const bf16* as = As + (kt % STAGES) * BM * LDA;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(af[mt], as + (wm * 64 + mt * 16 + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_trans(bfr[np], Bs + (kk + (lane & 15)) * LDB + wn * 32 + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma16816(acc[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2], bfr[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: the column scale on the fp32 sum, then bf16. Lane holds rows
  // g and g + 8 of each 16 x 8 tile, columns tig * 2 and tig * 2 + 1.
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + tig * 2;
      if (col >= N) continue;
      const float s0 = scale[col], s1 = scale[col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mt * 16 + g + half * 8;
        if (row >= M) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(acc[mt][nt][half * 2] * s0, acc[mt][nt][half * 2 + 1] * s1);
      }
    }
  }
}

template <bool VEC16>
int launch_gemm(const bf16* x, const int8_t* w, const float* scale, bf16* out, int M, int N,
                int K, cudaStream_t st) {
  constexpr size_t smem = gemm_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(gemm_kernel<VEC16>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<VEC16><<<grid, NTHREADS, smem, st>>>(x, w, scale, out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace anyref_i8

// Bytes of fp32 workspace anyref_int8_matmul needs for these shapes (the
// split-K partial sums of the M <= 16 body; 0 for M > 16).
ANYREF_API long long anyref_int8_matmul_workspace(int M, int N, int K) {
  if (M <= 0 || M > anyref_i8::GV_MAX_M || N <= 0 || K <= 0) return 0;
  return (long long)anyref_i8::gv_splits(K) * M * N * (long long)sizeof(float);
}

ANYREF_API int anyref_int8_matmul(const void* x, const void* w_q, const void* scale, void* out,
                                  void* workspace, int M, int N, int K, void* stream) {
  using namespace anyref_i8;
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  const bf16* xp = (const bf16*)x;
  const int8_t* wp = (const int8_t*)w_q;
  const float* sp = (const float*)scale;
  bf16* op = (bf16*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= GV_MAX_M) {
    if (!workspace) return (int)cudaErrorInvalidValue;
    float* ws = (float*)workspace;
    if (M == 1) return launch_gemv<1>(xp, wp, sp, op, ws, M, N, K, st);
    if (M == 2) return launch_gemv<2>(xp, wp, sp, op, ws, M, N, K, st);
    return launch_gemv<4>(xp, wp, sp, op, ws, M, N, K, st);
  }
  return N % 16 == 0 ? launch_gemm<true>(xp, wp, sp, op, M, N, K, st)
                     : launch_gemm<false>(xp, wp, sp, op, M, N, K, st);
}
