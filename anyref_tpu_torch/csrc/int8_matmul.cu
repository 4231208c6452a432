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
//   11008 at 3.35 TB/s. One launch streams W once, whatever M is. A block
//   owns 128 columns of W and a contiguous range of K; the S blocks that
//   split one column tile's K form a thread-block cluster (S <= 8, the
//   wrapper's launch plan ops/flash.py _int8_decode_plan: the fewest that
//   give every SM a block). In each block a producer warp keeps a 4-stage
//   ring in flight on full / empty mbarriers: W's int8 box of 64 rows x
//   128 columns (8 KB) by TMA, or by 8-byte cp.async where N % 16 != 0 (a
//   tensor map needs 16-byte row strides), beside x's bf16 box of the same
//   64 k (8 or 16 rows; rows past M and the K tail read 0), both in the
//   128-byte swizzle. Four consumer warps take one k16 slab of a stage each
//   and multiply it by mma.sync m16n8k16, computed transposed (out^T = W^T
//   x^T): the block's 128 columns are the A rows, x's rows B's 8 (M <= 8)
//   or 16 columns. A thread reads 16 bytes of each of its four rows of the
//   slab (the swizzle spreads a quarter warp's reads over all banks) and
//   converts them exactly to bf16 A fragments in registers (a byte permute
//   per four weights, then the prefill body's conversion below with the
//   0x43 bits in a register, one LOP3 a masked half); the sum is fp32. The
//   split-K sum stays in the launch: each block adds its four warps'
//   partials [M, 128] in its shared memory, and after a cluster barrier
//   rank r sums its share of the columns over ranks 0..S-1, in that order,
//   through distributed shared memory, then scales, rounds and stores
//   bf16. No workspace, no atomics, no second launch: the result is the
//   same from run to run. A 4-stage ring (four blocks an SM at M <= 8,
//   two above) measured as fast as 5 to 8 stages, and faster where S is
//   larger; eight consumer warps spilled (PERF.md §6).
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

// ---------------------------------------------------------------------------
// M <= 16: one launch, W streamed by TMA, the split-K sum in distributed
// shared memory
// ---------------------------------------------------------------------------
constexpr int DT_TN = 128;                   // columns of W a block: a warp's 8 x 16
constexpr int DT_BK = 64;                    // K rows a stage: four k16 slabs
constexpr int DT_STAGES = 4;
constexpr int DT_WARPS = 4;                  // consumer warps, one a slab; warp 4 produces
constexpr int DT_THREADS = 32 * (DT_WARPS + 1);
constexpr int DT_MAX_M = 16, DT_MAX_SPLITS = 8;
constexpr int DT_W_BOX = DT_BK * DT_TN;      // int8 W [64][128], 128B-swizzled
constexpr int DT_RS = DT_TN + 8;             // row stride (floats) of the partial sums
// bf16 x [8 NB][64], 128B-swizzled; NB = 1 (M <= 8) or 2
__host__ __device__ constexpr int dt_x_box(int nb) { return 8 * nb * DT_BK * 2; }
// the ring of stages, its barriers, the block's 128 column scales
__host__ __device__ constexpr int dt_smem(int nb) {
  return DT_STAGES * (DT_W_BOX + dt_x_box(nb)) + 2 * DT_STAGES * 8 + DT_TN * 4 + 1024;
}

// As i8x4_to_bf16x2, with its bf16 bits 0x43 in a register (m =
// 0x43004300): each masked half is one three-input LOP3, (u & mask) | m,
// where the compiler would issue an AND and an OR for two immediates.
__device__ __forceinline__ void i8x4_to_bf16x2_m(uint32_t u, uint32_t m, uint32_t& even,
                                                 uint32_t& odd) {
  uint32_t ae, be, ao, bo;
  const uint32_t v = u >> 8;
  const uint32_t lo = 0x007F007Fu, hi = 0x00800080u;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(ae) : "r"(u), "r"(lo), "r"(m));
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(be) : "r"(u), "r"(hi), "r"(m));
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(ao) : "r"(v), "r"(lo), "r"(m));
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(bo) : "r"(v), "r"(hi), "r"(m));
  const __nv_bfloat162 e = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&ae),
                                   *reinterpret_cast<const __nv_bfloat162*>(&be));
  const __nv_bfloat162 o = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&ao),
                                   *reinterpret_cast<const __nv_bfloat162*>(&bo));
  even = *reinterpret_cast<const uint32_t*>(&e);
  odd = *reinterpret_cast<const uint32_t*>(&o);
}

// Cluster barrier in two halves: arrive (release: this block's shared
// writes become visible to the cluster; relaxed: no ordering) and wait.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Two floats at shared address `p` of cluster block `rank`.
__device__ __forceinline__ float2 ld_cluster_f2(const void* p, uint32_t rank) {
  uint32_t a;
  float2 v;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  // volatile: kept after the cluster barrier that publishes the partials
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}

// Block (rank, tile) of a grid [S, ceil(N / 128)], clusters of S along x:
// columns [128 tile, + 128) of W and its stages of 64 rows [rank KT / S,
// (rank + 1) KT / S), KT = ceil(K / 64). Consumer warp c takes slab c of
// every stage. The A rows of a thread's products are its 16 columns
// (lane / 4) * 16 + 0..15: product j (0..7) takes columns 16 g + 2 j (row
// g) and + 1 (row g + 8), so a 16-byte row read serves all eight. The
// partial sums are stored [warp][m][q] with q = 16 j + 2 g + h for column
// 16 g + 2 j + h, rows DT_RS floats apart, so both the accumulator stores
// and the reduction's reads are free of bank conflicts.
template <int NB, bool W_TMA>
__global__ void __launch_bounds__(DT_THREADS, 2)
    decode_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                  const int8_t* __restrict__ w, const float* __restrict__ scale,
                  bf16* __restrict__ out, int M, int N, int K) {
  constexpr int X_BOX = dt_x_box(NB), ROWS = 8 * NB;
  constexpr int OFF_X = DT_STAGES * DT_W_BOX, OFF_BAR = OFF_X + DT_STAGES * X_BOX;
  constexpr int OFF_SCALE = OFF_BAR + 2 * DT_STAGES * 8;
  static_assert(DT_WARPS * ROWS * DT_RS * 4 <= OFF_BAR, "the partial sums fit the ring");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + DT_STAGES;
  float* scale_s = reinterpret_cast<float*>(smem + OFF_SCALE);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = gridDim.x, rank = blockIdx.x, n0 = blockIdx.y * DT_TN;
  const int KT = (K + DT_BK - 1) / DT_BK;
  const int kt0 = rank * KT / S, nst = (rank + 1) * KT / S - kt0;
  // stage i of the block's range into ring slot i % DT_STAGES: the whole
  // producer warp (lane 0 the TMA loads; every lane its share of W by
  // cp.async where W has no tensor map)
  auto issue = [&](int i) {
    const int s = i % DT_STAGES, k = (kt0 + i) * DT_BK;
    unsigned char* wt = smem + s * DT_W_BOX;
    if (lane == 0) {
      // expect_tx counts whole boxes: TMA counts the zero-filled bytes too
      mbar_arrive_expect_tx(&full[s], W_TMA ? X_BOX + DT_W_BOX : X_BOX);
      tma_load_2d(smem + OFF_X + s * X_BOX, &tm_x, &full[s], k, 0);
      if (W_TMA) tma_load_2d(wt, &tm_w, &full[s], n0, k);
    }
    if (!W_TMA) {
      for (int p = lane; p < DT_W_BOX / 8; p += 32) {
        const int r = p / (DT_TN / 8), c = (p % (DT_TN / 8)) * 8;
        const bool ok = k + r < K && n0 + c < N;
        cp_async8(wt + r * DT_TN + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15)),
                  ok ? w + (size_t)(k + r) * N + n0 + c : w, ok);
      }
      cp_async_mbar_arrive_noinc(&full[s]);
    }
  };
  // The producer warp sets up the barriers and issues the first ring of
  // loads before the block-wide barrier, so that they fly while the block
  // starts.
  if (warp == DT_WARPS) {
    if (lane == 0) {
      for (int s = 0; s < DT_STAGES; ++s) {
        mbar_init(&full[s], W_TMA ? 1 : 1 + 32);  // expect_tx (+ a noinc arrival per lane)
        mbar_init(&empty[s], DT_WARPS);
      }
      mbar_fence_init();
    }
    __syncwarp();
    for (int i = 0; i < nst && i < DT_STAGES; ++i) issue(i);
  }
  __syncthreads();

  float acc[8][NB][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][nb][i] = 0.f;
  const int g = lane >> 2, t = lane & 3;

  if (warp == DT_WARPS) {
    for (int i = DT_STAGES; i < nst; ++i) {
      mbar_wait(&empty[i % DT_STAGES], ((i / DT_STAGES) & 1) ^ 1);
      issue(i);
    }
    // every load issued: the epilogue's column scales, while the consumers
    // finish
    for (int c = lane; c < DT_TN; c += 32) scale_s[c] = n0 + c < N ? __ldg(scale + n0 + c) : 0.f;
  } else {
    // this thread's rows kr, kr + 1, kr + 8, kr + 9 of a stage: the k of
    // its A and B fragments in the warp's slab
    const int kr = 16 * warp + 2 * t;
    uint32_t m43;
    asm volatile("mov.b32 %0, 0x43004300;" : "=r"(m43));  // opaque: one LOP3 a half
    for (int i = 0; i < nst; ++i) {
      const int s = i % DT_STAGES;
      mbar_wait(&full[s], (i / DT_STAGES) & 1);
      // W: 16-byte chunk g of rows kr (+ 8) at g ^ 2 t, of rows kr + 1 (+ 8)
      // at g ^ (2 t + 1): the eight lanes of a quarter warp read eight
      // distinct chunks
      const unsigned char* wt = smem + s * DT_W_BOX + kr * DT_TN;
      const int c0 = (g ^ (2 * t)) << 4, c1 = (g ^ (2 * t + 1)) << 4;
      const uint4 r0 = *reinterpret_cast<const uint4*>(wt + c0);
      const uint4 r1 = *reinterpret_cast<const uint4*>(wt + DT_TN + c1);
      const uint4 r2 = *reinterpret_cast<const uint4*>(wt + 8 * DT_TN + c0);
      const uint4 r3 = *reinterpret_cast<const uint4*>(wt + 9 * DT_TN + c1);
      // B: x[row][kr, kr + 1] and [kr + 8, kr + 9], 16-byte chunk c of a
      // 128-byte row at c ^ (row & 7)
      const unsigned char* xt = smem + OFF_X + s * X_BOX;
      uint32_t b[NB][2];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int row = 8 * nb + g, c = kr >> 3;  // kr * 2 bytes: chunk kr / 8, byte 4 t
        const unsigned char* xr = xt + row * 128 + 4 * t;
        b[nb][0] = *reinterpret_cast<const uint32_t*>(xr + ((c ^ (row & 7)) << 4));
        b[nb][1] = *reinterpret_cast<const uint32_t*>(xr + (((c + 1) ^ (row & 7)) << 4));
      }
      const uint32_t w0[4] = {r0.x, r0.y, r0.z, r0.w}, w1[4] = {r1.x, r1.y, r1.z, r1.w};
      const uint32_t w2[4] = {r2.x, r2.y, r2.z, r2.w}, w3[4] = {r3.x, r3.y, r3.z, r3.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // word q: columns 16 g + 4 q .. + 3, products 2 q, 2 q + 1
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // (row k col c, row k col c + 1, row k + 1 col c, row k + 1 col
          // c + 1) -> the pairs (k, k + 1) of columns c (A row g) and c + 1
          // (A row g + 8)
          const uint32_t sel = h ? 0x7632u : 0x5410u;
          uint32_t a[4];
          i8x4_to_bf16x2_m(__byte_perm(w0[q], w1[q], sel), m43, a[0], a[1]);
          i8x4_to_bf16x2_m(__byte_perm(w2[q], w3[q], sel), m43, a[2], a[3]);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) mma16816(acc[2 * q + h][nb], a, b[nb][0], b[nb][1]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  // every stage consumed: the ring holds the partial sums. Accumulator
  // (d0, d2) is x row 8 nb + 2 t at columns 16 g + 2 j (+ 1), (d1, d3) the
  // next row.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (warp < DT_WARPS) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        float* p = red + (warp * ROWS + 8 * nb + 2 * t) * DT_RS + 16 * j + 2 * g;
        *reinterpret_cast<float2*>(p) = make_float2(acc[j][nb][0], acc[j][nb][2]);
        *reinterpret_cast<float2*>(p + DT_RS) = make_float2(acc[j][nb][1], acc[j][nb][3]);
      }
  }
  __syncthreads();
  // the block's partial sums: warps 0..DT_WARPS-1 added in that order into
  // warp 0's rows
  for (int e = threadIdx.x; e < M * (DT_TN / 2); e += DT_THREADS) {
    float* p = red + (e / (DT_TN / 2)) * DT_RS + 2 * (e % (DT_TN / 2));
    float2 sum = *reinterpret_cast<const float2*>(p);
#pragma unroll
    for (int wi = 1; wi < DT_WARPS; ++wi) {
      const float2 v = *reinterpret_cast<const float2*>(p + wi * ROWS * DT_RS);
      sum.x += v.x;
      sum.y += v.y;
    }
    *reinterpret_cast<float2*>(p) = sum;
  }
  if (S > 1) {
    cluster_arrive_release();
    cluster_wait();
  } else {
    __syncthreads();
  }
  // rank r: column pairs q / 2 in [r 64 / S, (r + 1) 64 / S) of the rows <
  // M, each the sum of the blocks' partials over ranks 0..S-1 in that
  // order, all S loads in flight at once
  const int p0 = rank * (DT_TN / 2) / S, np = (rank + 1) * (DT_TN / 2) / S - p0;
  for (int e = threadIdx.x; e < M * np; e += DT_THREADS) {
    const int m = e / np, q = 2 * (p0 + e % np);
    float2 v[DT_MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < DT_MAX_SPLITS; ++r)
      if (r < S) v[r] = ld_cluster_f2(red + m * DT_RS + q, r);
    float sx = 0.f, sy = 0.f;
#pragma unroll
    for (int r = 0; r < DT_MAX_SPLITS; ++r)
      if (r < S) {
        sx += v[r].x;
        sy += v[r].y;
      }
    const int c = 16 * ((q >> 1) & 7) + 2 * (q >> 4), n = n0 + c;
    if (n < N)  // N % 8 == 0: n + 1 < N as well
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
          __floats2bfloat162_rn(sx * scale_s[c], sy * scale_s[c + 1]);
  }
  if (S > 1) {  // no block leaves while another reads its partials
    cluster_arrive_relaxed();
    cluster_wait();
  }
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

template <int NB, bool W_TMA>
int launch_decode_kernel(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const int8_t* w,
                         const float* scale, bf16* out, int M, int N, int K, int S,
                         cudaStream_t st) {
  const auto kern = decode_kernel<NB, W_TMA>;
  constexpr int smem = dt_smem(NB);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, (N + DT_TN - 1) / DT_TN);
  cfg.blockDim = dim3(DT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = S;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  void* args[] = {const_cast<CUtensorMap*>(&tm_x), const_cast<CUtensorMap*>(&tm_w), &w, &scale,
                  &out, &M, &N, &K};
  e = cudaLaunchKernelExC(&cfg, (const void*)kern, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The decode body with S blocks a column tile (the wrapper's plan).
int launch_decode(const bf16* x, const int8_t* w, const float* scale, bf16* out, int M, int N,
                  int K, int S, cudaStream_t st) {
  const int nb = M <= 8 ? 1 : 2;
  CUtensorMap tm_x, tm_w;
  memset(&tm_w, 0, sizeof(tm_w));
  // x [M, K] bf16 in boxes of 8 nb rows x 64 (one 128-byte swizzle row)
  if (!make_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (uint64_t)K * 2, DT_BK, 8 * nb,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  // w_q [K, N] int8 in boxes of 64 rows x 128, where its rows are 16-byte
  // multiples
  const bool w_tma = N % 16 == 0;
  if (w_tma && !make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, N, DT_TN, DT_BK,
                         CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  if (nb == 1)
    return w_tma ? launch_decode_kernel<1, true>(tm_x, tm_w, w, scale, out, M, N, K, S, st)
                 : launch_decode_kernel<1, false>(tm_x, tm_w, w, scale, out, M, N, K, S, st);
  return w_tma ? launch_decode_kernel<2, true>(tm_x, tm_w, w, scale, out, M, N, K, S, st)
               : launch_decode_kernel<2, false>(tm_x, tm_w, w, scale, out, M, N, K, S, st);
}

}  // namespace anyref_i8

// tn, splits, bk: the wrapper's launch plan of the M <= 16 body (columns
// of W a block, the K split S that is the cluster size, K rows a stage);
// the body is compiled for tn = 128 and bk = 64 and refuses any other.
// Ignored for M > 16.
ANYREF_API int anyref_int8_matmul(const void* x, const void* w_q, const void* scale, void* out,
                                  int M, int N, int K, int tn, int splits, int bk, void* stream) {
  using namespace anyref_i8;
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  const bf16* xp = (const bf16*)x;
  const int8_t* wp = (const int8_t*)w_q;
  const float* sp = (const float*)scale;
  bf16* op = (bf16*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= DT_MAX_M) {
    if (tn != DT_TN || bk != DT_BK || splits < 1 || splits > DT_MAX_SPLITS ||
        splits > (K + DT_BK - 1) / DT_BK)
      return (int)cudaErrorInvalidValue;
    return launch_decode(xp, wp, sp, op, M, N, K, splits, st);
  }
  return launch_wgmma(xp, wp, sp, op, M, N, K, st);
}
