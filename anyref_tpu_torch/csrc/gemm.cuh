// The GEMM of the fused SAM layers: out[M, N] = epi(A[M, K] @ W[K, N] +
// bias) with bf16 operands in the tensor cores and an fp32 sum, on Hopper's
// wgmma fed by TMA (helpers in wgmma.cuh).
//
// - A is bf16 [M, K], K-major. Where a layer normalises its input first,
//   the LayerNorm row pass of norms.cu (anyref_layer_norm_rows) has written
//   A = bf16(LN(x) * pad mask) before: the TPU kernels round h to bf16 there
//   too (anyref_tpu/ops/flash.py:972, :1094, :1200), so the numbers are
//   those of a prologue in the GEMM, and each element is normalised once
//   instead of once for every column tile.
// - W is the bf16 weight [K, N], row-major as the parameter tree stores it:
//   the MN-major ("transposed") B operand of wgmma.
// - Epilogues on the fp32 accumulators: + bias -> bf16; + bias -> exact
//   GELU (erff) -> bf16; + bias + residual (bf16 or fp32) -> bf16 or fp32.
//   The bias is read in its own dtype (bf16 or fp32). Rows past M and
//   columns past N are not stored.
//
// Replaces the products that anyref_tpu/ops/flash.py's fused SAM kernels
// compute in their own bodies (_fused_window_attn_kernel: QKV, proj;
// _mlp_stream_kernel: fc1, fc2; _fused_window_block_kernel and
// _fused_global_tail_kernel: the same four).
//
// What bounds it on the H100: tensor-core operations. At SAM-H's shapes
// (M = 9800 window rows or 8192 global rows at batch 2; K, N = 1280 x 3840,
// 1280 x 1280, 1280 x 5120, 5120 x 1280) it does ~1000 operations a byte:
// 96.3, 32.1, 128.5 and 128.5 GFLOP at M = 9800, 0.097 / 0.032 / 0.130 /
// 0.130 ms at 989 TFLOP/s. Only wgmma reaches that rate. The design is the
// warp-specialised pattern of int8_matmul.cu's prefill body:
// - one persistent block a SM (grid = min(tiles, SMs)) walks output tiles
//   of BM = 128 rows by BN = 256 columns, column tiles of one row tile next
//   to each other (the A rows stay in L2 while W streams); the tile loop
//   evens out the wave tail (385 tiles at N = 1280 are 2.9 waves of 132)
//   and lets the producer load the next tile while the consumers store
//   this one;
// - a producer warpgroup (setmaxnreg 40; thread 0 issues every load) keeps
//   a ring of STAGES = 4 K-steps of 64 full by TMA: A's [128 x 64] box and
//   W's four [64 k x 64 n] boxes, all in the 128-byte swizzle, each stage
//   on a full / empty mbarrier pair; out-of-bounds rows and columns read 0;
// - two consumer warpgroups (setmaxnreg 232) each own 64 rows of the tile:
//   four m64n256k16 SS wgmmas a K-step (A K-major, W MN-major through
//   sw128_mn_desc), one commit group a step with one more in flight, the
//   stage of the step before released once its group has completed; the
//   accumulator is 128 fp32 registers a thread;
// - the epilogue adds bias and residual and applies GELU in fp32 on the
//   accumulators, rounds once, and goes out through shared memory in
//   chunks of 64 columns: each thread writes its pairs into a swizzled
//   [64 x 64] buffer of its warpgroup, then the warpgroup stores whole
//   rows of the chunk with 16-byte stores. Stored from the accumulator
//   layout, a warp's store wrote 16 bytes in each of 8 rows, half of a
//   32-byte sector each, and the stores were the largest loss of the
//   first version (PERF.md). A residual tile is prefetched into L2 when
//   its tile starts, and each chunk issues its loads before its stores.
// K and N must be multiples of 8 and A and W 16-byte aligned (TMA's
// 16-byte row strides); the wrapper raises otherwise.
#pragma once

#include "wgmma.cuh"

namespace anyref_mm {

enum Epi { E_BIAS = 0, E_BIAS_GELU = 1, E_BIAS_RES = 2 };

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int NTHREADS = 384;        // producer + 2 consumer warpgroups
constexpr int A_TILE = BM * BK * 2;  // bf16 [128 rows][64 k], swizzled
constexpr int B_BLOCK = BK * 128;    // one [64 k][64 n] box of W
constexpr int B_TILE = BN / 64 * B_BLOCK;
constexpr int EJ = 8;                // column groups of 8 an epilogue chunk: 64 columns
constexpr int OUT_CHUNK = 64 * EJ * 8 * 4;  // a warpgroup's [64 x 64] chunk, fp32 at most
constexpr int OFF_B = STAGES * A_TILE, OFF_BAR = OFF_B + STAGES * B_TILE;
constexpr int OFF_OUT = OFF_BAR + 128;  // the barriers, then one chunk a warpgroup
constexpr int SMEM = OFF_OUT + 2 * OUT_CHUNK + 1024;  // + slack to align to 1024

struct Params {
  const void* bias;  // [N], bf16 or (bias_f32) fp32
  const void* res;   // [M, N] residual (E_BIAS_RES), bf16 or fp32
  void* out;         // [M, N]
  int M, N, K, bias_f32;
};

__device__ __forceinline__ float gelu_exact(float x) {
  return x * 0.5f * (1.f + erff(x * 0.70710678118654752f));
}

// Elements i and i + 1 of an fp32 (f32) or bf16 array, as fp32.
__device__ __forceinline__ float2 load_pair(const void* a, bool f32, size_t i) {
  if (f32) return make_float2(static_cast<const float*>(a)[i], static_cast<const float*>(a)[i + 1]);
  const bf16* b = static_cast<const bf16*>(a);
  return make_float2(__bfloat162float(b[i]), __bfloat162float(b[i + 1]));
}

// Ask for one 128-byte line into L2, without waiting for it.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

template <int EPI, bool RES_F32, bool OUT_F32>
__global__ void __launch_bounds__(NTHREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x >> 7;
  const int tiles_n = (p.N + BN - 1) / BN, tiles = (p.M + BM - 1) / BM * tiles_n;
  const int KT = (p.K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Producer and consumers walk the same (tile, K-step) sequence; `it`
  // counts its steps, stage it % STAGES, phase (it / STAGES) & 1.
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);  // passes at once on the first round
          // expect_tx counts whole boxes: TMA counts the zero-filled bytes too
          mbar_arrive_expect_tx(&full[s], A_TILE + B_TILE);
          tma_load_2d(smem + s * A_TILE, &tm_a, &full[s], kt * BK, m0);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load_2d(smem + OFF_B + s * B_TILE + c * B_BLOCK, &tm_b, &full[s], n0 + 64 * c,
                        kt * BK);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1, tid = threadIdx.x & 127, warp = tid >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    // descriptors of the block's shared memory, A K-major and W MN-major
    // (64-column blocks B_BLOCK apart); each wgmma's is a base plus an offset
    const uint64_t kmajor = sw128_desc(smem), mnmajor = sw128_mn_desc(smem, B_BLOCK);
    const uint32_t a_rows = cw * 64 * 128;  // this warpgroup's 64 rows of the A tile
    unsigned char* chunk = smem + OFF_OUT + cw * OUT_CHUNK;
    float acc[BN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
      if constexpr (EPI == E_BIAS_RES) {
        // the tile's residual lines into L2 while the products run
        constexpr int ES = RES_F32 ? 4 : 2, LINES = BN * ES / 128;
        for (int i = threadIdx.x - 128; i < BM * LINES; i += 256) {
          const int row = m0 + i / LINES, col = n0 + i % LINES * (128 / ES);
          if (row < p.M && col < p.N)
            prefetch_l2(static_cast<const char*>(p.res) + ((size_t)row * p.N + col) * ES);
        }
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss<BN, 1>(acc, desc_at(kmajor, s * A_TILE + a_rows + 32 * kk),
                          desc_at(mnmajor, OFF_B + s * B_TILE + 2048 * kk),
                          kt > 0 || kk > 0);  // the tile's first product overwrites
        wgmma_commit();
        wgmma_wait<1>();
        // the step before has completed: release its stage
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);

      // epilogue. The thread holds rows rl and rl + 8 of the warpgroup's 64
      // (acc[4 j + {0, 1}] and acc[4 j + {2, 3}]) at columns 8 j + 2 t and
      // + 1 of the tile. A chunk's rows are ES * 64 bytes in the buffer,
      // 16-byte unit u of row q at unit u ^ (q & 7): the 8 rows a warp
      // writes at once, and the 8 units a row is read in, fall in distinct
      // banks.
      constexpr int ES = OUT_F32 ? 4 : 2, ROW = ES * 64, UNITS = ROW / 16;
      const int rl = 16 * warp + g, r = m0 + 64 * cw + rl;
      const bool row_ok[2] = {r < p.M, r + 8 < p.M};
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += EJ) {
        const int c0 = n0 + 8 * j0;  // the chunk's first column
        if (c0 >= p.N) break;
        // every load of the chunk before its first store
        float2 bv[EJ], rv[EJ][2];
#pragma unroll
        for (int jj = 0; jj < EJ; ++jj) {
          const int col = c0 + 8 * jj + 2 * t;  // N % 8 == 0: col + 1 < N too
          bv[jj] = col < p.N ? load_pair(p.bias, p.bias_f32, col) : make_float2(0.f, 0.f);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            rv[jj][h] = make_float2(0.f, 0.f);
            if (EPI == E_BIAS_RES && col < p.N && row_ok[h])
              rv[jj][h] = load_pair(p.res, RES_F32, (size_t)(r + 8 * h) * p.N + col);
          }
        }
#pragma unroll
        for (int jj = 0; jj < EJ; ++jj) {
          const int j = j0 + jj;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = acc[4 * j + 2 * h] + bv[jj].x, v1 = acc[4 * j + 2 * h + 1] + bv[jj].y;
            if (EPI == E_BIAS_GELU) {
              v0 = gelu_exact(v0);
              v1 = gelu_exact(v1);
            } else if (EPI == E_BIAS_RES) {
              v0 += rv[jj][h].x;
              v1 += rv[jj][h].y;
            }
            const int q = rl + 8 * h, byte = (8 * jj + 2 * t) * ES;  // byte in the row
            unsigned char* dst =
                chunk + q * ROW + ((((byte >> 4) ^ (q & 7)) << 4) | (byte & 15));
            if (OUT_F32)
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            else
              *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
          }
        }
        named_bar_sync(1 + cw, 128);  // the chunk is in the buffer
#pragma unroll
        for (int i = tid; i < 64 * UNITS; i += 128) {
          const int q = i / UNITS, u = i % UNITS, row = m0 + 64 * cw + q;
          const int col = c0 + u * 16 / ES;  // a unit lies wholly inside or past N
          if (row < p.M && col < p.N)
            *reinterpret_cast<uint4*>(static_cast<unsigned char*>(p.out) +
                                      ((size_t)row * p.N + col) * ES) =
                *reinterpret_cast<const uint4*>(chunk + q * ROW + ((u ^ (q & 7)) << 4));
        }
        named_bar_sync(1 + cw, 128);  // the buffer is free for the next chunk
      }
    }
  }
}

// A row-major bf16 [rows, cols] matrix read in 128-byte-swizzled boxes of
// box_rows x 64 columns; out-of-bounds elements read 0.
static inline bool bf16_rows_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                                 int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

static inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
    return 132;
  return n;
}

template <int EPI, bool RES_F32, bool OUT_F32>
inline int launch(const void* a, const void* w, const Params& p, void* stream) {
  if (p.M <= 0 || p.N <= 0) return 0;
  if (p.N % 8 || p.K % 8 || p.K <= 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_b;
  if (!bf16_rows_map(&tm_a, a, p.M, p.K, BM) || !bf16_rows_map(&tm_b, w, p.K, p.N, BK))
    return (int)cudaErrorInvalidValue;
  auto kern = gemm_kernel<EPI, RES_F32, OUT_F32>;
  // The consumers' setmaxnreg.inc takes the registers the producer's .dec
  // gives back; that balances only at the 168 registers a thread that
  // __launch_bounds__(384, 1) allows. Refuse any other build rather than
  // let the consumers wait for registers forever.
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return (int)e;
  if (attr.numRegs != 168) return (int)cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (p.M + BM - 1) / BM * ((p.N + BN - 1) / BN), sms = sm_count();
  const int grid = tiles < sms ? tiles : sms;
  kern<<<grid, NTHREADS, SMEM, (cudaStream_t)stream>>>(tm_a, tm_b, p);
  return (int)cudaGetLastError();
}

}  // namespace anyref_mm
