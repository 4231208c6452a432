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
//   (2 M N K: 42.9 GFLOP at 1280 x 4096 x 4096, 0.043 ms at 989 TFLOP/s),
//   which only wgmma reaches on Hopper. A warp-specialised kernel (helpers
//   in wgmma.cuh), one block of three warpgroups per SM, each block a tile
//   of 192 rows of x by 128 columns of W, computed transposed (out^T = W^T
//   x^T) so that the int8 operand is converted in registers and never
//   written back to shared memory as bf16. The producer warpgroup (40
//   registers) keeps a 4-stage ring of K steps of 64 in flight: x's tile by
//   TMA in the 128-byte swizzle that wgmma reads as its B operand, W's int8
//   tile (8 KB, half the bytes of bf16) by TMA in the same swizzle, or by
//   8-byte cp.async where N % 16 != 0, each stage on a full / empty
//   mbarrier pair. Each consumer warpgroup owns 64 columns of W: a thread
//   loads its int8 weights of a stage at once (two adjacent columns, one
//   16-bit load per k), converts them exactly to bf16 A fragments in
//   registers (v = bf16(128 + low 7 bits) - bf16(128 + 128 sign): two LOP3
//   and half a bf16x2 subtraction a weight) and issues m64n192k16 RS
//   wgmmas, one per commit group, converting the next slab while three are
//   in flight. The conversion is what an int8 weight adds to a bf16 GEMM,
//   and it sets the design: its ALU work is fixed per weight, so the wide
//   x tile (192, wgmma's N) divides it over more products, and loading a
//   whole stage's weights at once pays their latency once a step, not once
//   a slab. The column scale is applied to the fp32 accumulators, rounded,
//   and stored from registers.
//
// K and N must be multiples of 8 and x and w_q 16-byte aligned.
#include "wgmma.cuh"

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
// M > 16: warp-specialised wgmma GEMM, x by TMA, int8 W converted in
// registers
// ---------------------------------------------------------------------------
// BM rows of x by BN columns of W a block. BM = 192 (wgmma N): 128 left the
// conversion too large a share of each product and 256 runs out of
// registers (ptxas serialises the wgmmas, C7512); 192 also cuts M = 1280
// into 7 tiles, 224 blocks for N = 4096 (1.7 waves on 132 SMs).
constexpr int BM = 192, BN = 128, BK = 64, STAGES = 4;
constexpr int NTHREADS = 384;                  // producer + 2 consumer warpgroups
constexpr int X_TILE = BM * BK * 2;            // bf16 x tile [m][k], 128B-swizzled
constexpr int WQ_TILE = BK * BN;               // int8 W tile [k][n], 128B-swizzled
constexpr int OFF_WQ = STAGES * X_TILE;
constexpr int OFF_BAR = OFF_WQ + STAGES * WQ_TILE;
constexpr int SMEM_BYTES = OFF_BAR + 2 * STAGES * 8 + 1024;  // + slack to align to 1024
constexpr int CONSUMER_WARPS = 8;

// 8-byte global -> shared copy (.ca: the .cg form takes 16 bytes only),
// zero-filled when !valid.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 8 : 0));
}

// Four int8 (b0, b1, b2, b3) in a word -> the exact bf16 pairs (b0, b2) and
// (b1, b3). Each byte v = m - 128 s (m its low 7 bits, s its sign bit) is
// bf16(128 + m) - bf16(128 + 128 s): both terms are bf16 bit patterns 0x43
// followed by the byte's bits (masked), and the difference is exact.
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t u, uint32_t& even, uint32_t& odd) {
  const uint32_t m = 0x43004300u;
  __nv_bfloat162 a, b;
  const uint32_t ae = (u & 0x007F007Fu) | m, be = (u & 0x00800080u) | m;
  const uint32_t ao = ((u >> 8) & 0x007F007Fu) | m, bo = ((u >> 8) & 0x00800080u) | m;
  a = *reinterpret_cast<const __nv_bfloat162*>(&ae);
  b = *reinterpret_cast<const __nv_bfloat162*>(&be);
  const __nv_bfloat162 e = __hsub2(a, b);
  a = *reinterpret_cast<const __nv_bfloat162*>(&ao);
  b = *reinterpret_cast<const __nv_bfloat162*>(&bo);
  const __nv_bfloat162 o = __hsub2(a, b);
  even = *reinterpret_cast<const uint32_t*>(&e);
  odd = *reinterpret_cast<const uint32_t*>(&o);
}

// This thread's int8 weights of one stage, for the wgmma A fragments of
// its four k16 slabs. The warpgroup's 64 A rows are 64 columns of W, mapped
// so that a thread's rows g and g + 8 are the adjacent columns `col`,
// `col + 1`: one 16-bit load gives both at one k. raw[j][0] holds (col @ k,
// col + 1 @ k, col @ k + 1, col + 1 @ k + 1) at k = 16 j + 2 t, raw[j][1]
// the same at k + 8. off_e / off_o: the swizzled offset of the two bytes in
// an even / odd row of the tile. All sixteen loads are issued together, so
// their latency is paid once a stage, not once a slab.
__device__ __forceinline__ void load_stage(const unsigned char* wq, int t, int off_e, int off_o,
                                           uint32_t (&raw)[4][2]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned char* r = wq + (16 * j + 2 * t) * BN;
    raw[j][0] = *reinterpret_cast<const unsigned short*>(r + off_e) |
                (uint32_t)*reinterpret_cast<const unsigned short*>(r + BN + off_o) << 16;
    raw[j][1] = *reinterpret_cast<const unsigned short*>(r + 8 * BN + off_e) |
                (uint32_t)*reinterpret_cast<const unsigned short*>(r + 9 * BN + off_o) << 16;
  }
}

// One slab's raw words -> its A fragment (rows g, g + 8; k, k + 8).
__device__ __forceinline__ void convert_fragment(const uint32_t (&raw)[2], uint32_t (&f)[4]) {
  i8x4_to_bf16x2(raw[0], f[0], f[1]);
  i8x4_to_bf16x2(raw[1], f[2], f[3]);
}

// One block: a BM (m) x BN (n) tile of out, computed transposed: each
// consumer warpgroup multiplies 64 columns of W (A, converted into
// registers) by the BM rows of x (B, [m][k] in shared memory as TMA leaves
// it). Warpgroup 0 produces: its first warp keeps a ring of STAGES (x tile,
// int8 W tile) pairs filled, x by TMA and W by TMA (W_TMA, N % 16 == 0) or
// by 8-byte cp.async from all 32 lanes (N % 16 != 0: TMA needs 16-byte row
// strides), both in the 128-byte swizzle, each stage signalled on its full
// barrier. A consumer releases a stage on its empty barrier (one arrival
// per consumer warp) once the wgmmas that read it have completed.
template <bool W_TMA>
__global__ void __launch_bounds__(NTHREADS, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                 const int8_t* __restrict__ w, const float* __restrict__ scale,
                 bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x >> 7;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int KT = (K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], W_TMA ? 1 : 1 + 32);  // expect_tx (+ a noinc arrival per lane)
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<40>();
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 32) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);  // passes at once on the first round
        if (lane == 0) {
          // expect_tx counts whole boxes: TMA counts the zero-filled bytes too
          mbar_arrive_expect_tx(&full[s], W_TMA ? X_TILE + WQ_TILE : X_TILE);
          tma_load_2d(smem + s * X_TILE, &tm_x, &full[s], kt * BK, m0);
          if (W_TMA) tma_load_2d(smem + OFF_WQ + s * WQ_TILE, &tm_w, &full[s], n0, kt * BK);
        }
        if (!W_TMA) {
          unsigned char* wq = smem + OFF_WQ + s * WQ_TILE;
          for (int i = lane; i < WQ_TILE / 8; i += 32) {
            const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
            const int k = kt * BK + r, n = n0 + c;
            const bool ok = k < K && n < N;
            cp_async8(wq + r * BN + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15)),
                      ok ? w + (size_t)k * N + n : w, ok);
          }
          cp_async_mbar_arrive_noinc(&full[s]);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int col = 64 * cw + 16 * warp + 2 * g;  // this thread's W columns col, col + 1
    const int off_e = (((col >> 4) ^ (2 * t)) << 4) | (col & 15);
    const int off_o = (((col >> 4) ^ (2 * t + 1)) << 4) | (col & 15);
    float acc[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
    uint32_t raw[4][2];  // the int8 weights of a step
    uint32_t f[4][4];    // the fragments of its four k16 slabs

    // One wgmma a commit group, as CUTLASS's mixed-input mainloop: slab j's
    // wgmma is issued, then, once at most three groups are in flight (slab
    // j - 3, the last reader of f[(j + 1) % 4], has completed), the next
    // slab is converted into f[(j + 1) % 4] while the three run; after the
    // last slab the next stage's weights are loaded all at once. Fragments
    // are defined only after a wgmma_wait, never between a wgmma_fence and
    // the wait of its group: ptxas would serialise the wgmmas (C7513).
    mbar_wait(&full[0], 0);
    load_stage(smem + OFF_WQ, t, off_e, off_o, raw);
    convert_fragment(raw[0], f[0]);
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) fence_operand(acc[i]);
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % STAGES;
      const unsigned char* x = smem + s * X_TILE;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint64_t dx = sw128_desc(x + 32 * j);
        fence_operand(dx);
        wgmma_fence();
        wgmma_m64n192k16_bf16_rs(acc, f[j], dx);
        wgmma_commit();
        wgmma_wait<3>();
        if (j < 3) {
          convert_fragment(raw[j + 1], f[j + 1]);
        } else {
          // step kt - 1 has completed: release its stage
          if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
          if (kt + 1 < KT) {
            const int s1 = (kt + 1) % STAGES;
            mbar_wait(&full[s1], ((kt + 1) / STAGES) & 1);
            load_stage(smem + OFF_WQ + s1 * WQ_TILE, t, off_e, off_o, raw);
            convert_fragment(raw[0], f[0]);
          }
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) fence_operand(acc[i]);

    // epilogue: accumulator row g / g + 8 is column n / n + 1 of out,
    // accumulator columns 8 j + 2 t (+ 1) are rows m (+ 1); the column scale
    // on the fp32 sum, then bf16
    const int n = n0 + col;
    if (n < N) {  // N % 8 == 0: n + 1 < N as well
      const float s0 = __ldg(scale + n), s1 = __ldg(scale + n + 1);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const int m = m0 + 8 * j + 2 * t;
        if (m < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
              __floats2bfloat162_rn(acc[4 * j] * s0, acc[4 * j + 2] * s1);
        if (m + 1 < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(m + 1) * N + n) =
              __floats2bfloat162_rn(acc[4 * j + 1] * s0, acc[4 * j + 3] * s1);
      }
    }
  }
}

// A row-major [outer, inner] tensor with rows `row_bytes` apart, read in
// boxes of box_outer x box_inner elements; out-of-bounds elements read 0.
static bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* p, uint64_t inner,
                     uint64_t outer, uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer,
                     CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  return make_tensor_map(map, type, 2, p, dims, strides, box, swizzle);
}

int launch_wgmma(const bf16* x, const int8_t* w, const float* scale, bf16* out, int M, int N,
                 int K, cudaStream_t st) {
  CUtensorMap tm_x, tm_w;
  memset(&tm_w, 0, sizeof(tm_w));
  // x [M, K] bf16 in boxes of 128 rows x 64 (one 128-byte swizzle row)
  if (!make_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (uint64_t)K * 2, BK, BM,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  // w_q [K, N] int8 in boxes of 64 rows x 128, where its rows are 16-byte
  // multiples
  const bool w_tma = N % 16 == 0;
  if (w_tma && !make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, N, BN, BK,
                         CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  auto kern = w_tma ? wgmma_kernel<true> : wgmma_kernel<false>;
  // The consumers' setmaxnreg.inc takes the registers the producer's .dec
  // gives back; that balances only at the 168 registers a thread that
  // __launch_bounds__(384, 1) allows. Refuse any other build rather than
  // let the consumers wait for registers forever.
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return (int)e;
  if (attr.numRegs != 168) return (int)cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, NTHREADS, SMEM_BYTES, st>>>(tm_x, tm_w, w, scale, out, M, N, K);
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
  return launch_wgmma(xp, wp, sp, op, M, N, K, st);
}
