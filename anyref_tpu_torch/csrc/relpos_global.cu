// SAM ViTDet attention with decomposed relative-position bias over grids of
// more than 256 tokens (the global layers):
// softmax(q k^T * scale + rh[q, key / W] + rw[q, key % W]) v; and, with
// the bias compiled out, CLIP's plain softmax attention (below).
//
// Replaces, above 256 tokens, anyref_tpu/ops/flash.py's query-blocked
// global kernel _relpos_kernel (flash_relpos_attention) and the attention
// half of _fused_global_tail_kernel (fused_global_tail, and
// flash_relpos_attention_qkv, whose wrapper shares it). Main path: SAM-H's
// global layers, [2, 16, 4096, 80], H = W = 64, as split heads, as the
// unfused path's views permuted out of a fused QKV, and as column slices of
// the fused QKV [2, 4096, 3840] written head-merged. Windows (at most 256
// tokens) go to window_attention.cu.
//
// What it computes, as the plain versions relpos_attention_plain and
// fused_relpos_attention_plain: fp32 scores, bias, softmax and running
// sums; P rounded to bf16 for the P V product and the sum divided by the
// row sum at the end (the fused plain version normalises P before the
// rounding: one bf16 rounding of P apart, ROADMAP C1). The factors rh
// [B * nh, L, H] and rw [B * nh, L, W] are fp32 inputs, the wrapper's two
// einsums (relpos_factors), as the reference computes them in XLA.
//
// Bound on the H100: tensor-core operations, 4 * B * nh * L^2 * hd = 171.8
// GFLOP at [2, 16, 4096, 80] (0.174 ms at 989 TFLOP/s), against 0.03 ms for
// the bytes. Only wgmma reaches that rate. The design is the causal
// forward's (causal_attention.cu) without its mask:
// - one block per (128-query tile, batch * head), query tiles of one head
//   side by side in the grid so that their K and V stay in L2; two consumer
//   warpgroups of 64 rows, 256 threads, thread 0 issuing every TMA load;
// - q, k and v read in place through a 4-D tensor map (hd, L, nh, B) with
//   the view's strides, so split heads, permuted heads and slices of a
//   fused QKV all load without a copy; columns past hd and rows past L read
//   zero, never the next head or batch;
// - S = Q K^T by m64n128k16 RS wgmma, Q in registers, hd / 16 k-steps (5
//   at hd = 80, not the 8 of a width rounded to 128); O += P V by RS wgmma
//   with V MN-major and N = hd rounded to 16 (80: one 64-column swizzle
//   block and 16 columns of the next); FlashAttention-3's intra-warpgroup
//   overlap and ping-pong, the online softmax in log2 units; every block
//   walks all L / 128 key tiles, only keys past L (a ragged last tile) are
//   dropped;
// - the bias is added in fp32 to the scores in the accumulator registers.
//   At W = 64 a thread's 32 columns of a 128-key tile have the same key % W
//   on every tile: the block's 128 rows of rw (log2 units) are staged once
//   in shared memory, and each thread reads its 16 values a row as 8-byte
//   loads, one per pair of columns, without bank conflicts (the 8-column
//   groups of row r swizzled by r % 4); rh is two values a row a tile,
//   loaded from device memory a tile ahead. Other W (never SAM's global
//   grids) look both up per key.
// Shared memory: 128-byte-swizzled 64-column blocks, so a 128 x 80 tile
// takes two blocks (32 KB). Q and a K/V ring of three stages are then 224
// KB and leave no room for the factor rows, so the rw rows (32 KB) take
// Q's place once both warpgroups hold Q as registers: three stages at
// every width (with two, a tile's loads are issued only one tile ahead,
// and the kernel ran slower). Not chosen: a narrower swizzle for the last
// 16 columns (20 KB a tile), after which no single P V wgmma could span
// both blocks; rw in registers (32 a thread beside O, S, P and Q's
// fragments made ptxas spill); a cluster of two blocks sharing each K/V
// tile by TMA multicast (half the L2 reads, but it ran slower: the kernel
// is not held by L2's bandwidth); a producer warpgroup with setmaxnreg
// (ptxas then fits the whole kernel in the 168 registers of 384 threads
// and spills); rh added to the halves' maxima instead of to every score
// (a few percent, but a spill at hd = 128).
//
// The bias-free kernel (BIAS = false, anyref_attention_heads) replaces
// anyref_tpu/ops/flash.py flash_attention_qkv (_mha_qkv_kernel): CLIP-L's
// attention off its fused QKV [2, 257, 3072], 16 heads of 64, read in
// place through the same tensor maps and written head-merged; unnormalised
// P rounded to bf16, the sum divided by the fp32 row sum after the product,
// as attention_qkv_plain. Bound: 4.2 MB of bytes, 0.0013 ms, and 0.54
// GFLOP, 0.0005 ms, so it is held by latency: one block's chain of loads,
// products and softmaxes, and how the grid fills the 132 SMs. Hence:
// - one consumer warpgroup of 64 queries a block (WGS = 1): 160 blocks at
//   CLIP's shape, two fitting a SM (104 KB of shared memory, at most 255
//   registers of 128 threads), against 96 blocks of two warpgroups, which
//   were no faster there and slower on smaller grids;
// - L = 257 leaves one key in a third 128-key tile: a last tile of at most
//   32 or 64 keys takes products (m64n32 / m64n64 S, 2 or 4 P V k-steps)
//   and a softmax of that width, with an accumulator of its own (a view
//   of the scores' registers made ptxas serialise the wgmmas, C7511);
// - three stages hold every tile at L <= 384: no refill on CLIP's path,
//   and a first pass of S over the resident tiles takes each row's true
//   maximum, so that P is rounded to bf16 at it, as the reference rounds
//   it (the online softmax rounds each tile's P at the running maximum:
//   equally precise against fp64, but a tiny LoRA train step through CLIP
//   drifted from the CPU's twice as far). The pass ends on tile 0, whose
//   scores are used as they are; it costs ~0.001 ms at CLIP's shape.
// Not chosen: the exact single pass with every score in registers (272 a
// row beside O and P, more than a warpgroup holds).
#include "wgmma.cuh"

namespace anyref_rpg {

constexpr int BN = 128;           // keys a tile
constexpr int CHUNK = 128 * 128;  // bytes of one 64-column block of a 128-row K/V tile
constexpr float LOG2E = 1.4426950408889634f;

// NC 64-column blocks of a tile (hd <= 64: 1, else 2), WGS consumer
// warpgroups of 64 query rows. With the bias, Q's region holds the block's
// rw rows [BM][64] fp32 once Q is in registers.
template <int NC, bool BIAS, int WGS>
struct Layout {
  static constexpr int STAGES = 3;
  static constexpr int BM = 64 * WGS, QCHUNK = BM * 128;
  static constexpr int TILE = NC * CHUNK, QTILE = NC * QCHUNK, RW_BYTES = BIAS ? BM * 64 * 4 : 0;
  static constexpr int Q = 0, RW = 0, K = QTILE > RW_BYTES ? QTILE : RW_BYTES;
  static constexpr int V = K + STAGES * TILE, BAR = V + STAGES * TILE;
  static constexpr int BYTES = BAR + (1 + 3 * STAGES) * 8 + 1024;  // + slack to align
};

// A key count known at compile time: the width of a tile's products.
template <int N>
struct Keys {
  static constexpr int n = N;
};

struct Args {
  const float *rh, *rw;  // BIAS: [B * nh, L, H], [B * nh, L, W] fp32, contiguous
  bf16* out;             // row r of head (b, h) at b * osb + h * osh + r * osr
  int osb, osh, osr;
  int nh, L, hd, H, W;
  float scale_log2;      // the scale (hd^-0.5) * log2(e)
};

// NK = hd rounded up to 16, over 16: the k-steps of Q K^T and P V's N / 16.
// BIAS: add the rel-pos bias of rh and rw (else plain softmax attention).
// WGS: consumer warpgroups, 64 query rows each (128 threads a warpgroup).
template <int NK, bool BIAS, int WGS>
__global__ void __launch_bounds__(128 * WGS, 1)
    global_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const Args a) {
  constexpr int HDP = 16 * NK, NC = (HDP + 63) / 64, NTHREADS = 128 * WGS;
  using Lo = Layout<NC, BIAS, WGS>;
  constexpr int STAGES = Lo::STAGES, BM = Lo::BM;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + Lo::BAR);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;  // one arrival per warp done with a stage

  const int bh = blockIdx.y, b = bh / a.nh, h = bh % a.nh;
  const int L = a.L, q0 = blockIdx.x * BM;
  const int n_tiles = (L + BN - 1) / BN;

  // K and V of tile i into stage i % STAGES, each on its full barrier
  auto load_kv = [&](int i) {
    const int s = i % STAGES, k0 = i * BN;
    mbar_arrive_expect_tx(&kfull[s], Lo::TILE);
    for (int c = 0; c < NC; ++c)
      tma_load_4d(smem + Lo::K + s * Lo::TILE + c * CHUNK, &tm_k, &kfull[s], 64 * c, k0, h, b);
    mbar_arrive_expect_tx(&vfull[s], Lo::TILE);
    for (int c = 0; c < NC; ++c)
      tma_load_4d(smem + Lo::V + s * Lo::TILE + c * CHUNK, &tm_v, &vfull[s], 64 * c, k0, h, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], NTHREADS / 32);
    }
    mbar_fence_init();
    mbar_arrive_expect_tx(qfull, Lo::QTILE);
    for (int c = 0; c < NC; ++c)
      tma_load_4d(smem + Lo::Q + c * Lo::QCHUNK, &tm_q, qfull, 64 * c, q0, h, b);
    for (int i = 0; i < min(STAGES, n_tiles); ++i) load_kv(i);
  }
  __syncthreads();

  const int w = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's two query rows: accumulator rows g and g + 8 of its warp
  const int r0 = q0 + 64 * w + 16 * warp + g, r1 = r0 + 8;
  // their factor rows (a row past L reads row L - 1: it is never written)
  const int W = a.W, H = a.H;
  const float* rh0 = a.rh + ((size_t)bh * L + min(r0, L - 1)) * H;
  const float* rh1 = a.rh + ((size_t)bh * L + min(r1, L - 1)) * H;
  const float* rw0 = a.rw + ((size_t)bh * L + min(r0, L - 1)) * W;
  const float* rw1 = a.rw + ((size_t)bh * L + min(r1, L - 1)) * W;
  const bool w64 = BIAS && W == 64;
  // W = 64: the block's rows of rw in log2 units, and rh of the tile's two
  // grid rows for this thread's rows, raw, a tile ahead
  // (row r, column c) of rw at r * 64 + (c ^ 8 (r % 4)): the 8-byte loads
  // of a half-warp (rows g < 4, columns 2 t + 8 j) fall in 32 banks
  float* rws = reinterpret_cast<float*>(smem + Lo::RW);
  float rhn[4];
  auto load_rh = [&](int i) {
    const int j0 = 2 * i, j1 = min(2 * i + 1, H - 1);
    rhn[0] = rh0[j0];
    rhn[1] = rh0[j1];
    rhn[2] = rh1[j0];
    rhn[3] = rh1[j1];
  };

  // descriptors of the block's shared memory, K-major and V's MN-major;
  // each wgmma's is this base plus a constant offset
  const uint64_t kmajor = sw128_desc(smem), mnmajor = sw128_mn_desc(smem, CHUNK);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float sc[64];
  uint32_t pa[8][4];
  uint32_t qa[NK][4];  // the warpgroup's Q as the A fragments of S = Q K^T

  // The products and the softmax of a tile take its first N keys: N = BN
  // but for a short last tile of the bias-free kernel, whose scores have an
  // accumulator of their own (sv: float[N / 2], sc at N = BN).
  // S [64 x N] = Q K^T of tile i into sv, issued and committed
  auto issue_s = [&](int i, auto& sv) {
    constexpr int N = sizeof(sv) / sizeof(float) * 2;
    const int s = i % STAGES;
    mbar_wait(&kfull[s], (i / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int off = (kk >> 2) * CHUNK + (kk & 3) * 32;
      wgmma_rs<N, 0>(sv, qa[kk], desc_at(kmajor, Lo::K + s * Lo::TILE + off), kk);
    }
    wgmma_commit();
  };
  // O [64 x HDP] += bf16(P) V of tile i, P in pa, V [N keys x HDP]
  // MN-major, issued and committed
  auto issue_pv = [&](int i, auto keys) {
    constexpr int N = decltype(keys)::n;
    const int s = i % STAGES;
    mbar_wait(&vfull[s], (i / STAGES) & 1);
#pragma unroll
    for (int j = 0; j < HDP / 2; ++j) fence_operand(o[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_rs<HDP, 1>(o, pa[kk], desc_at(mnmajor, Lo::V + s * Lo::TILE + kk * 2048));
    wgmma_commit();
  };
  // tile i's scores in sv, scaled to log2 units, biased and masked; mx0 /
  // mx1 their maxima over the tile in rows r0 and r1. The thread holds rows
  // r0 (sv[4 j + e]) and r1 (sv[4 j + 2 + e]) at keys k0 + 8 j + 2 t + e,
  // j < N / 8.
  auto scores = [&](int i, auto& sv, float& mx0, float& mx1) {
    constexpr int NJ = sizeof(sv) / sizeof(float) / 4;
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) fence_operand(sv[j]);
    const int k0 = i * BN;
    const float sl2 = a.scale_log2;
    if constexpr (!BIAS) {
#pragma unroll
      for (int j = 0; j < 4 * NJ; ++j) sv[j] *= sl2;
    } else if (w64) {
      // keys 8 j + 2 t + e of the tile lie in grid row 2 i (j < 8) or
      // 2 i + 1, at grid column 8 (j % 8) + 2 t + e
      const float h00 = LOG2E * rhn[0], h01 = LOG2E * rhn[1];
      const float h10 = LOG2E * rhn[2], h11 = LOG2E * rhn[3];
      if (i + 1 < n_tiles) load_rh(i + 1);
      const float* rwa = rws + (r0 - q0) * 64 + 2 * t;
      const float* rwb = rwa + 8 * 64;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // two column groups' loads at a time: hoisting all 16 spilled
        if (j % 2 == 0) asm volatile("" ::: "memory");
        const float2 wa = *reinterpret_cast<const float2*>(rwa + 8 * (j ^ (g & 3)));
        const float2 wb = *reinterpret_cast<const float2*>(rwb + 8 * (j ^ (g & 3)));
        sv[4 * j] = fmaf(sv[4 * j], sl2, h00 + wa.x);
        sv[4 * j + 1] = fmaf(sv[4 * j + 1], sl2, h00 + wa.y);
        sv[4 * j + 2] = fmaf(sv[4 * j + 2], sl2, h10 + wb.x);
        sv[4 * j + 3] = fmaf(sv[4 * j + 3], sl2, h10 + wb.y);
        sv[4 * j + 32] = fmaf(sv[4 * j + 32], sl2, h01 + wa.x);
        sv[4 * j + 33] = fmaf(sv[4 * j + 33], sl2, h01 + wa.y);
        sv[4 * j + 34] = fmaf(sv[4 * j + 34], sl2, h11 + wb.x);
        sv[4 * j + 35] = fmaf(sv[4 * j + 35], sl2, h11 + wb.y);
      }
    } else {
      // key k0 + 8 j + 2 t + e at grid (kh, kw), stepped from key to key
      // (a division for each of the 32 keys held the registers of all 32
      // quotients); keys past L read the grid's last row
      int kh = (k0 + 2 * t) / W, kw = k0 + 2 * t - kh * W;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int hh = min(kh, H - 1);
          sv[4 * j + e] = fmaf(sv[4 * j + e], sl2, LOG2E * (rh0[hh] + rw0[kw]));
          sv[4 * j + 2 + e] = fmaf(sv[4 * j + 2 + e], sl2, LOG2E * (rh1[hh] + rw1[kw]));
          asm volatile("" ::: "memory");  // one key's loads at a time
          for (kw += e ? 7 : 1; kw >= W; kw -= W) ++kh;
        }
      }
    }
    if (k0 + 8 * NJ > L) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (k0 + 8 * j + 2 * t + e >= L)  // not a key at all: weight exactly 0
            sv[4 * j + e] = sv[4 * j + 2 + e] = -INFINITY;
        }
      }
    }
    mx0 = mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx0 = fmaxf(mx0, sv[4 * j + e]);
        mx1 = fmaxf(mx1, sv[4 * j + 2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
  };
  // scores in sv with tile maxima mx0 / mx1 -> unnormalised P in sv (fp32);
  // the running max and sums move on, and a0 / a1 are the factors that
  // rescale O's rows
  auto exp_sums = [&](float& a0, float& a1, auto& sv, float mx0, float mx1) {
    constexpr int NJ = sizeof(sv) / sizeof(float) / 4;
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: key k0 < L
    a0 = ex2(m0 - mn0);  // 0 on the first tile
    a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sv[4 * j + e] = ex2(sv[4 * j + e] - mn0);
        sv[4 * j + 2 + e] = ex2(sv[4 * j + 2 + e] - mn1);
        ps0 += sv[4 * j + e];
        ps1 += sv[4 * j + 2 + e];
      }
    }
    l0 = l0 * a0 + ps0;  // this lane's share of the row sums
    l1 = l1 * a1 + ps1;
  };
  // tile i's scores in sv -> unnormalised P in sv, as above
  auto softmax = [&](int i, float& a0, float& a1, auto& sv) {
    float mx0, mx1;
    scores(i, sv, mx0, mx1);
    exp_sums(a0, a1, sv, mx0, mx1);
  };
  auto rescale_o = [&](float a0, float a1) {
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
  };
  // tile i - 1's stage is done with in this warp; the first thread of the
  // last warpgroup (which issues its products after the other's) refills it
  // with tile i - 1 + STAGES once every warp is
  auto release = [&](int i) {
    const int s = (i - 1) % STAGES;
    if (lane == 0) mbar_arrive(&empty[s]);
    if (threadIdx.x == NTHREADS - 128 && i - 1 + STAGES < n_tiles) {
      mbar_wait(&empty[s], ((i - 1) / STAGES) & 1);
      load_kv(i - 1 + STAGES);
    }
  };

  // Software pipeline (the causal forward's): while P_{i-1} V_{i-1} runs on
  // the tensor cores, S_i is waited for and turned into P_i; O is rescaled
  // only once the product into it has completed. Two warpgroups take turns
  // to issue (named barriers 1 and 2, warpgroup 0 first).
  auto my_turn = [&]() {
    if constexpr (WGS == 2) named_bar_sync(1 + w, NTHREADS);
  };
  auto your_turn = [&]() {
    if constexpr (WGS == 2) named_bar_arrive(2 - w, NTHREADS);
  };
  float a0, a1;
  mbar_wait(qfull, 0);
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    sw128_frag(qa[kk], smem + Lo::Q + w * 64 * 128, Lo::QCHUNK, kk);
  if (w64) {
    __syncthreads();  // Q is in registers: its space takes the rw rows
    for (int i = threadIdx.x; i < BM * 16; i += NTHREADS) {
      const int r = i >> 4, c = (i & 15) * 4;
      const float4 x = *reinterpret_cast<const float4*>(
          a.rw + ((size_t)bh * L + min(q0 + r, L - 1)) * 64 + c);
      *reinterpret_cast<float4*>(rws + r * 64 + (c ^ ((r & 3) << 3))) =
          make_float4(LOG2E * x.x, LOG2E * x.y, LOG2E * x.z, LOG2E * x.w);
    }
    load_rh(0);
    __syncthreads();
  }
  // A last tile of at most 32 or 64 keys (CLIP's L = 257: one) takes
  // products and a softmax of that width in the bias-free kernel: a third
  // or less of a whole tile's work
  using Whole = Keys<BN>;
  const int rem = L - (n_tiles - 1) * BN;
  const int last_n = BIAS || n_tiles == 1 ? BN : rem <= 32 ? 32 : rem <= 64 ? 64 : BN;
  const int n_whole = last_n < BN ? n_tiles - 1 : n_tiles;
  // Without the bias, where every tile stays in shared memory (L <= 384,
  // CLIP's 257), a first pass of S takes each row's maximum over all keys:
  // P is then rounded to bf16 at the row's true maximum, as the reference
  // rounds it, and never rescaled (a0 = a1 = 1). The pass ends on tile 0,
  // whose scores the second pass takes as they are. Longer rows run the
  // online softmax alone.
  bool exact = false;
  if constexpr (!BIAS) {
    if (n_tiles <= STAGES) {
      exact = true;
      auto row_max = [&](int i, auto& sv) {
        issue_s(i, sv);
        wgmma_wait<0>();
        float mx0, mx1;
        scores(i, sv, mx0, mx1);
        m0 = fmaxf(m0, mx0);
        m1 = fmaxf(m1, mx1);
      };
      if (last_n == 32) {
        float sn[16];
        row_max(n_tiles - 1, sn);
      } else if (last_n == 64) {
        float sn[32];
        row_max(n_tiles - 1, sn);
      }
      for (int i = n_whole - 1; i >= 0; --i) row_max(i, sc);
    }
  }
  if (WGS == 2 && w == 1) named_bar_arrive(1, NTHREADS);
  if (exact) {
    exp_sums(a0, a1, sc, m0, m1);
  } else {
    my_turn();
    issue_s(0, sc);
    your_turn();
    wgmma_wait<0>();
    softmax(0, a0, a1, sc);
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) acc_to_frag(sc, kk, pa[kk]);
  for (int i = 1; i < n_whole; ++i) {
    my_turn();
    issue_s(i, sc);
    issue_pv(i - 1, Whole{});
    your_turn();
    wgmma_wait<1>();  // S_i; P_{i-1} V_{i-1} may still run
    softmax(i, a0, a1, sc);
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < HDP / 2; ++j) fence_operand(o[j]);
    release(i);
    rescale_o(a0, a1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) acc_to_frag(sc, kk, pa[kk]);
  }
  // the short last tile, as one more step of the loop (no stage left to
  // refill), then the last tile's P V; every product's wait lies in the
  // branch that issued it
  auto last_steps = [&](auto keys) {
    constexpr int N = decltype(keys)::n;
    const int i = n_tiles - 1;
    if constexpr (N < BN) {
      float sn[N / 2];
      my_turn();
      issue_s(i, sn);
      issue_pv(i - 1, Whole{});
      your_turn();
      wgmma_wait<1>();
      softmax(i, a0, a1, sn);
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < HDP / 2; ++j) fence_operand(o[j]);
      rescale_o(a0, a1);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) acc_to_frag(sn, kk, pa[kk]);
    }
    my_turn();
    issue_pv(i, keys);
    if (WGS == 2 && w == 0) named_bar_arrive(2, NTHREADS);  // warpgroup 1 issues last
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < HDP / 2; ++j) fence_operand(o[j]);
  };
  if constexpr (BIAS) {
    last_steps(Whole{});
  } else {
    if (last_n == 32) last_steps(Keys<32>{});
    else if (last_n == 64) last_steps(Keys<64>{});
    else last_steps(Whole{});
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // out = O / l; the clamp matches the reference's max(denom, 1e-20)
  const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
  bf16* ob = a.out + (size_t)b * a.osb + (size_t)h * a.osh;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int d = 8 * j + 2 * t;
    if (d < a.hd) {
      if (r0 < L)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * a.osr + d) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1 < L)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * a.osr + d) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// The bf16 heads [B, nh, L, hd] of a view whose row r of head (b, h) lies
// at p + b * sb + h * sh + r * sr (elements), as a 4-D tensor map (hd, L,
// nh, B) read in 128-byte-swizzled boxes of `rows` rows x 64 columns of one
// head: rows past L and columns past hd read 0.
static bool head_map(CUtensorMap* map, const void* p, int B, int nh, int L, int hd, int sb,
                     int sh, int sr, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)L, (cuuint64_t)nh, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sr * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, p, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int NK, bool BIAS, int WGS>
int launch(const void* q, const void* k, const void* v, int B, int sb, int sh, int sr,
           const Args& a, cudaStream_t st) {
  using Lo = Layout<(16 * NK + 63) / 64, BIAS, WGS>;
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, q, B, a.nh, a.L, a.hd, sb, sh, sr, Lo::BM) ||
      !head_map(&tk, k, B, a.nh, a.L, a.hd, sb, sh, sr, BN) ||
      !head_map(&tv, v, B, a.nh, a.L, a.hd, sb, sh, sr, BN))
    return (int)cudaErrorInvalidValue;
  const void* kern = (const void*)global_kernel<NK, BIAS, WGS>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Lo::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.L + Lo::BM - 1) / Lo::BM, B * a.nh);
  global_kernel<NK, BIAS, WGS><<<grid, 128 * WGS, Lo::BYTES, st>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

// Checks common to both entries, then the instance for hd rounded up to 16.
template <bool BIAS, int WGS>
int dispatch(const void* q, const void* k, const void* v, int sb, int sh, int sr, int B,
             const Args& a, void* stream) {
  if (B <= 0 || a.L <= 0) return 0;
  if (a.nh <= 0 || a.hd <= 0 || a.hd > 128 || a.hd % 8) return (int)cudaErrorInvalidValue;
  if ((sb | sh | sr | a.osb | a.osh | a.osr) % 8 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)a.out) % 16)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = (cudaStream_t)stream;
  if (a.hd <= 32) return launch<2, BIAS, WGS>(q, k, v, B, sb, sh, sr, a, st);
  if (a.hd <= 48) return launch<3, BIAS, WGS>(q, k, v, B, sb, sh, sr, a, st);
  if (a.hd <= 64) return launch<4, BIAS, WGS>(q, k, v, B, sb, sh, sr, a, st);
  if (a.hd <= 80) return launch<5, BIAS, WGS>(q, k, v, B, sb, sh, sr, a, st);
  return launch<8, BIAS, WGS>(q, k, v, B, sb, sh, sr, a, st);
}

}  // namespace anyref_rpg

// q, k, v: bf16 views whose row r of head (b, h) lies at base + b * sb +
// h * sh + r * sr (elements; the three share the strides), bases 16-byte
// aligned, strides multiples of 8, hd a multiple of 8 up to 128
// (ops/flash.py copies and pads other operands); rh [B * nh, L, H] and rw
// [B * nh, L, W] fp32 contiguous, H * W = L; out likewise through osb,
// osh, osr (multiples of 8, 16-byte aligned base).
ANYREF_API int anyref_relpos_global(const void* q, const void* k, const void* v, int sb, int sh,
                                    int sr, const void* rh, const void* rw, void* out, int osb,
                                    int osh, int osr, int B, int nh, int L, int hd, int H, int W,
                                    float scale, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (H <= 0 || W <= 0 || (long long)H * W != L) return (int)cudaErrorInvalidValue;
  const anyref_rpg::Args a = {(const float*)rh, (const float*)rw, (bf16*)out, osb, osh, osr,
                              nh, L, hd, H, W, scale * anyref_rpg::LOG2E};
  return anyref_rpg::dispatch<true, 2>(q, k, v, sb, sh, sr, B, a, stream);
}

// softmax(q k^T * scale) v, no bias: q, k, v and out as in
// anyref_relpos_global. 64 query rows a block (one warpgroup).
ANYREF_API int anyref_attention_heads(const void* q, const void* k, const void* v, int sb, int sh,
                                      int sr, void* out, int osb, int osh, int osr, int B, int nh,
                                      int L, int hd, float scale, void* stream) {
  const anyref_rpg::Args a = {nullptr, nullptr, (bf16*)out, osb, osh, osr,
                              nh,      L,       hd,         0,   0,   scale * anyref_rpg::LOG2E};
  return anyref_rpg::dispatch<false, 1>(q, k, v, sb, sh, sr, B, a, stream);
}
