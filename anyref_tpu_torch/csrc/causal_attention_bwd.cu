// Backward of the training attention (causal, per-row left pad kv_start).
//
// Replaces the two backward kernels of anyref_tpu/ops/flash.py
// flash_causal_attention_diff: _causal_dq_kernel (blocked over queries) and
// _causal_dkv_kernel (blocked over keys), with the same split: one kernel
// over query blocks writes dQ, one over key blocks holds dK and dV for its
// block in registers while it walks the query tiles at or below the
// diagonal. No atomics, so the result is the same in every run (the
// checkpointed train step recomputes the forward and must see the same
// values). Main-path shape: q/k/v/out/dout [2, 32, 768, 128] bf16, lse and
// delta [64, 768] fp32.
//
// What the reference computes and this keeps: p = exp(s - lse) in fp32 from
// the forward's saved log-sum-exp, selected to zero where the causal or pad
// mask drops the key (never multiplied: a fully masked row's lse is
// float32.min, where exp(s - lse) overflows); dP = dO V^T in fp32 (bf16
// products are exact in fp32, so the tensor cores' fp32 accumulation is
// the reference's fp32 product); dS = p (dP - delta) scale with delta =
// rowsum(dO * O) from the wrapper, as the reference's wrapper computes it;
// dQ = bf16(dS) K and dK = bf16(dS^T) Q, rounded to bf16 as the reference
// rounds them. One difference: the reference's dV = P^T dO is fp32 x fp32;
// here P^T is rounded to bf16 for the tensor cores (one bf16 rounding of P,
// within the tolerance chip_smoke.py holds the kernel to against the plain
// version).
//
// Bound on the H100: tensor-core operations, 10 hd per kept (query, key)
// pair (S and dP recomputed, dV, dQ, dK): 24 us at [2, 32, 768, 128] at 989
// TFLOP/s, against 30 us for the bytes. The two kernels recompute S and dP
// each (14 hd a pair). Design, as the forward (causal_attention.cu): a
// block is two warpgroups of 64 rows each, 256 threads (more than 8 warps
// would leave a thread 168 registers: dK and dV alone take 128 at hd =
// 128); one thread issues the TMA loads into a 3-stage ring on full
// mbarriers and refills a stage once every warp has arrived at its empty
// barrier; every operand in the 128-byte swizzle, hd zero-filled to 64 or
// 128 columns; S and dP (or their transposes) as SS wgmmas, both K-major,
// into fp32 registers, where p and dS are formed and rounded to bf16 as
// the A fragments of RS wgmmas whose B (K, Q or dO, with the keys or
// queries as wgmma's K) is read MN-major. Each issue point issues one
// tile's S and dP with the previous tile's RS products, whose fragments
// are double-buffered, so dS is formed while those run; the two
// warpgroups take turns to issue (ping-pong). Tiles wholly above the
// diagonal or before the pad are skipped (every entry there is masked to
// zero); only the tiles on the diagonal, across the pad or past L pay for
// the mask.
// - dq: a block owns 128 queries; Q, dO (and each row's lse and delta, in
//   registers) are loaded once; 64-key tiles of K and V stream from the
//   pad to the diagonal; per tile S = Q K^T and dP = dO V^T (m64n64k16),
//   then dQ += bf16(dS) K (m64n{64,128}k16, 64 or 128 fp32 registers). The
//   last query blocks (the longest walks) launch first.
// - dkv: a block owns 128 keys; K and V are loaded once; 64-query tiles of
//   Q and dO (by TMA) and their lse and delta (by cp.async) stream from the
//   diagonal (or the pad) to L; per half tile of 32 queries S^T = K Q^T and
//   dP^T = V dO^T (m64n32k16), then dV += bf16(P^T) dO and dK += bf16(dS^T)
//   Q. Both accumulators stay in registers (64 + 64 fp32 a thread at hd =
//   128), as four tuples of 32, which is why the scores come in halves.
#include <float.h>

#include "wgmma.cuh"

namespace anyref_bwd {

constexpr int BLK = 128;            // queries (dq) or keys (dkv) a block
constexpr int TN = 64;              // keys (dq) or queries (dkv) a streamed tile
constexpr int STAGES = 3;
constexpr int NTHREADS = 256;       // two warpgroups
constexpr int CH_BLK = BLK * 128;   // bytes of one 64-column block of 128 rows
constexpr int CH_TN = TN * 128;     // ... of 64 rows
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const int* kv_start;       // [B] or null
  const float *lse, *delta;  // [B * nh, L]
  bf16 *dq, *dk, *dv;        // [B * nh, L, hd]
  int nh, L, hd;
  float scale, scale_log2;
};

// Shared memory of both kernels: two resident operands of BLK rows (dq: Q,
// dO; dkv: K, V), a ring of two streamed operands of TN rows (dq: K, V;
// dkv: Q, dO), dkv's lse and delta per stage, and the barriers.
template <int NC>
struct Layout {
  static constexpr int RES = NC * CH_BLK, STR = NC * CH_TN;
  static constexpr int A = 0, B = RES, SA = 2 * RES, SB = SA + STAGES * STR;
  static constexpr int LSE = SB + STAGES * STR, DELTA = LSE + STAGES * TN * 4;
  static constexpr int BAR = DELTA + STAGES * TN * 4;
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8 + 1024;  // + slack to align
};

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// Store rows r0 and r0 + 8 of a warpgroup's fp32 accumulator [64 x N] (this
// thread's rows) as bf16 into the first `cols` columns of an [L, ld] matrix.
template <int N>
__device__ __forceinline__ void store_rows(bf16* dst, const float* acc, int r0, int L, int cols,
                                           int ld, int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int d = 8 * j + 2 * t;
    if (d < cols) {
      if (r0 < L)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r0 * ld + d) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      if (r0 + 8 < L)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(r0 + 8) * ld + d) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq: 128 queries a block, 64-key tiles
// ---------------------------------------------------------------------------
// Thread 0 loads Q, dO and the ring's first K / V tiles; thread 128 (the
// warpgroup that issues second) refills each later stage.
template <int NC>
__global__ void __launch_bounds__(NTHREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
              const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
              const Args a) {
  using Lo = Layout<NC>;
  constexpr int HDP = 64 * NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* rfull = reinterpret_cast<uint64_t*>(smem + Lo::BAR);
  uint64_t* full = rfull + 1;
  uint64_t* empty = full + STAGES;  // one arrival per warp done with a stage

  const int L = a.L, bh = blockIdx.x, b = bh / a.nh;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLK;  // the longest walks first
  const int pad = a.kv_start ? a.kv_start[b] : 0;
  // key tiles not wholly before the pad nor above the diagonal; a block of
  // rows wholly inside the pad walks none (dq = 0)
  const int kt_begin = pad / TN;
  const int kt_end = min((L + TN - 1) / TN, (q0 + BLK - 1) / TN + 1);
  const int n_tiles = max(kt_end - kt_begin, 0);

  // K and V of tile i into stage i % STAGES, on that stage's full barrier
  auto load_kv = [&](int i) {
    const int s = i % STAGES, k0 = (kt_begin + i) * TN;
    mbar_arrive_expect_tx(&full[s], 2 * Lo::STR);
    for (int c = 0; c < NC; ++c) {
      tma_load_3d(smem + Lo::SA + s * Lo::STR + c * CH_TN, &tm_k, &full[s], 64 * c, k0, bh);
      tma_load_3d(smem + Lo::SB + s * Lo::STR + c * CH_TN, &tm_v, &full[s], 64 * c, k0, bh);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(rfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NTHREADS / 32);
    }
    mbar_fence_init();
    if (n_tiles > 0) {
      mbar_arrive_expect_tx(rfull, 2 * Lo::RES);
      for (int c = 0; c < NC; ++c) {
        tma_load_3d(smem + Lo::A + c * CH_BLK, &tm_q, rfull, 64 * c, q0, bh);
        tma_load_3d(smem + Lo::B + c * CH_BLK, &tm_do, rfull, 64 * c, q0, bh);
      }
      for (int i = 0; i < min(STAGES, n_tiles); ++i) load_kv(i);
    }
  }
  __syncthreads();

  const int w = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * w + 16 * warp + g, r1 = r0 + 8;  // this thread's query rows
  // descriptors of the block's shared memory, K-major and MN-major; each
  // wgmma's is this base plus a constant offset
  const uint64_t kmajor = sw128_desc(smem), mnmajor = sw128_mn_desc(smem, CH_TN);
  const int qoff = Lo::A + w * 64 * 128, dooff = Lo::B + w * 64 * 128;  // the warpgroup's rows
  const size_t row0 = (size_t)bh * L;
  const float lse0 = r0 < L ? a.lse[row0 + r0] * LOG2E : 0.f;  // -inf on a fully masked row
  const float lse1 = r1 < L ? a.lse[row0 + r1] * LOG2E : 0.f;
  const float dl0 = r0 < L ? a.delta[row0 + r0] : 0.f;
  const float dl1 = r1 < L ? a.delta[row0 + r1] : 0.f;
  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  // S = Q K^T and dP = dO V^T [64 x 64] of the current tile
  float sc[32], dp[32];
  // bf16(dS) as the A fragments of dQ += dS K, of tiles of parity b
  uint32_t fa[2][4][4];

  // S and dP of tile i, issued and committed
  auto issue_sdp = [&](int i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      const int off = (kk & 3) * 32;
      wgmma_ss<64, 0>(sc, desc_at(kmajor, qoff + (kk >> 2) * CH_BLK + off),
                      desc_at(kmajor, Lo::SA + s * Lo::STR + (kk >> 2) * CH_TN + off), kk);
    }
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      const int off = (kk & 3) * 32;
      wgmma_ss<64, 0>(dp, desc_at(kmajor, dooff + (kk >> 2) * CH_BLK + off),
                      desc_at(kmajor, Lo::SB + s * Lo::STR + (kk >> 2) * CH_TN + off), kk);
    }
    wgmma_commit();
  };
  // dQ [64 x HDP] += bf16(dS) K of tile i (fragments fa[b]), K [64 keys x
  // HDP] MN-major, issued and committed
  auto issue_dq = [&](int i, int b) {
    const int s = i % STAGES;
#pragma unroll
    for (int j = 0; j < HDP / 2; ++j) fence_operand(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<HDP, 1>(acc, fa[b][kk], desc_at(mnmajor, Lo::SA + s * Lo::STR + kk * 2048));
    wgmma_commit();
  };
  // dS = p (dP - delta) scale of tile i, p = exp(s scale - lse) where kept,
  // rounded into fa[b]. Element x of slice kk is sc[8 kk + x]: row r0
  // (x & 2 == 0) or r1, key k0 + 8 j + 2 t + (x & 1), j = 2 kk + x / 4.
  auto form_ds = [&](int i, int b) {
    const int k0 = (kt_begin + i) * TN;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      fence_operand(sc[j]);
      fence_operand(dp[j]);
    }
    const bool need_mask = k0 + TN - 1 > q0 || k0 < pad || k0 + TN > L;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float ds[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int kj = k0 + 8 * (2 * kk + (x >> 2)) + 2 * t + (x & 1);
        float p = ex2(sc[8 * kk + x] * a.scale_log2 - (x & 2 ? lse1 : lse0));
        if (need_mask) {
          const bool keep = kj < L && kj >= pad && kj <= (x & 2 ? r1 : r0);
          p = keep ? p : 0.f;
        }
        ds[x] = p * (dp[8 * kk + x] - (x & 2 ? dl1 : dl0)) * a.scale;
      }
#pragma unroll
      for (int y = 0; y < 4; ++y) fa[b][kk][y] = pack_bf16(ds[2 * y], ds[2 * y + 1]);
    }
  };
  // tile i - 1's stage is done with in this warp; thread 128 (warpgroup 1,
  // which issues after warpgroup 0) refills it with tile i - 1 + STAGES
  // once every warp is
  auto release = [&](int i) {
    const int s = (i - 1) % STAGES;
    if (lane == 0) mbar_arrive(&empty[s]);
    if (threadIdx.x == 128 && i - 1 + STAGES < n_tiles) {
      mbar_wait(&empty[s], ((i - 1) / STAGES) & 1);
      load_kv(i - 1 + STAGES);
    }
  };
  // Tile i (parity b), as the forward: S_i and dP_i are issued with tile
  // i - 1's dQ product, and turned into dS_i while that product runs; the
  // two warpgroups take turns to issue (named barriers 1 and 2, warpgroup 0
  // first).
  auto step = [&](int i, int b) {
    named_bar_sync(1 + w, NTHREADS);
    issue_sdp(i);
    issue_dq(i - 1, b ^ 1);
    named_bar_arrive(2 - w, NTHREADS);
    wgmma_wait<1>();  // S_i, dP_i; tile i - 1's dQ may still run
    form_ds(i, b);
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < HDP / 2; ++j) fence_operand(acc[j]);
    release(i);
  };

  if (n_tiles > 0) {
    mbar_wait(rfull, 0);
    if (w == 1) named_bar_arrive(1, NTHREADS);
    named_bar_sync(1 + w, NTHREADS);
    issue_sdp(0);
    named_bar_arrive(2 - w, NTHREADS);
    wgmma_wait<0>();
    form_ds(0, 0);
    for (int i = 1; i < n_tiles; i += 2) {
      step(i, 1);
      if (i + 1 < n_tiles) step(i + 1, 0);
    }
    if ((n_tiles - 1) & 1) {  // the last tile's fragments into fa[0]
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int y = 0; y < 4; ++y) fa[0][kk][y] = fa[1][kk][y];
    }
    named_bar_sync(1 + w, NTHREADS);
    issue_dq(n_tiles - 1, 0);
    if (w == 0) named_bar_arrive(2, NTHREADS);  // warpgroup 1 issues last
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < HDP / 2; ++j) fence_operand(acc[j]);
  }
  store_rows<HDP>(a.dq + row0 * a.hd, acc, r0, L, a.hd, a.hd, t);
}

// ---------------------------------------------------------------------------
// dkv: 128 keys a block, 64-query tiles
// ---------------------------------------------------------------------------
// dK and dV take 128 fp32 registers a thread at hd = 128; beside them the
// scores need more than the 168 a thread that a block of more than 8 warps
// leaves (each of an SM's four register partitions, 16384 registers, then
// holds three warps; ptxas spilled and serialised the wgmmas with a
// producer warp, at 9 warps and at 12 with setmaxnreg). Thread 0 loads K
// and V; warp 4 (the first of the warpgroup that issues second) loads each
// 64-query tile: Q and dO by TMA, its lse and delta by cp.async.
template <int NC>
__global__ void __launch_bounds__(NTHREADS, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
               const Args a) {
  using Lo = Layout<NC>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* rfull = reinterpret_cast<uint64_t*>(smem + Lo::BAR);
  uint64_t* full = rfull + 1;
  uint64_t* empty = full + STAGES;  // one arrival per warp done with a stage

  const int L = a.L, bh = blockIdx.x, b = bh / a.nh;
  const int k0 = blockIdx.y * BLK;  // the first key blocks walk the longest
  const int pad = a.kv_start ? a.kv_start[b] : 0;
  // query tiles at or below the diagonal (queries >= k0) and not before the
  // pad; a key block wholly before the pad is masked for every query
  const int qt_end = (L + TN - 1) / TN;
  const int qt_begin = k0 + BLK <= pad ? qt_end : max(k0, pad) / TN;
  const int n_tiles = qt_end - qt_begin;

  float* ls = reinterpret_cast<float*>(smem + Lo::LSE);    // [STAGES][TN]
  float* dls = reinterpret_cast<float*>(smem + Lo::DELTA);  // [STAGES][TN]
  const size_t row0 = (size_t)bh * L;
  const int w = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // Q and dO of tile i into stage i % STAGES by TMA, the tile's lse and
  // delta by 4-byte cp.async, all on that stage's full barrier; run by one
  // whole warp (warp 4, the first of warpgroup 1)
  auto load_tile = [&](int i) {
    const int s = i % STAGES, q0 = (qt_begin + i) * TN;
    for (int c = lane; c < TN; c += 32) {
      const int qi = q0 + c;
      const bool ok = qi < L;
      cp_async4(ls + s * TN + c, a.lse + (ok ? row0 + qi : 0), ok);
      cp_async4(dls + s * TN + c, a.delta + (ok ? row0 + qi : 0), ok);
    }
    cp_async_mbar_arrive_noinc(&full[s]);
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[s], 2 * Lo::STR);
      for (int c = 0; c < NC; ++c) {
        tma_load_3d(smem + Lo::SA + s * Lo::STR + c * CH_TN, &tm_q, &full[s], 64 * c, q0, bh);
        tma_load_3d(smem + Lo::SB + s * Lo::STR + c * CH_TN, &tm_do, &full[s], 64 * c, q0, bh);
      }
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(rfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // lane 0's arrival with the bytes, one per cp.async lane
      mbar_init(&empty[s], NTHREADS / 32);
    }
    mbar_fence_init();
    if (n_tiles > 0) {
      mbar_arrive_expect_tx(rfull, 2 * Lo::RES);
      for (int c = 0; c < NC; ++c) {
        tma_load_3d(smem + Lo::A + c * CH_BLK, &tm_k, rfull, 64 * c, k0, bh);
        tma_load_3d(smem + Lo::B + c * CH_BLK, &tm_v, rfull, 64 * c, k0, bh);
      }
    }
  }
  __syncthreads();
  const bool loader = w == 1 && warp == 0;
  if (loader)
    for (int i = 0; i < min(STAGES, n_tiles); ++i) load_tile(i);

  const int kj0 = k0 + 64 * w + 16 * warp + g, kj1 = kj0 + 8;  // this thread's keys
  const bool kok0 = kj0 >= pad, kok1 = kj1 >= pad;
  // descriptors of the block's shared memory, K-major and MN-major; each
  // wgmma's is this base plus a constant offset
  const uint64_t kmajor = sw128_desc(smem), mnmajor = sw128_mn_desc(smem, CH_TN);
  const int koff = Lo::A + w * 64 * 128, voff = Lo::B + w * 64 * 128;  // the warpgroup's keys
  // dK and dV as NC accumulators of 64 columns each (wgmma's N = 64), not
  // one of HDP: smaller register tuples
  float dk[NC][32], dv[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;
  // each 64-query tile in two halves of 32 queries: S^T and dP^T [64 x 32]
  // of the current half, and bf16(P^T) and bf16(dS^T) as the A fragments of
  // half h's products in pa[h], sa[h]
  float st[16], dpt[16];
  uint32_t pa[2][2][4], sa[2][2][4];

  // S^T = K Q^T and dP^T = V dO^T of tile i, half h, issued and committed
  auto issue_s = [&](int i, int h) {
    const int s = i % STAGES;
    const int qa = Lo::SA + s * Lo::STR + h * 32 * 128;  // the half's 32 rows of Q
    const int da = Lo::SB + s * Lo::STR + h * 32 * 128;  // and of dO
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      const int off = (kk >> 2) * CH_TN + (kk & 3) * 32;
      wgmma_ss<32, 0>(st, desc_at(kmajor, koff + (kk >> 2) * CH_BLK + (kk & 3) * 32),
                      desc_at(kmajor, qa + off), kk);
    }
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      const int off = (kk >> 2) * CH_TN + (kk & 3) * 32;
      wgmma_ss<32, 0>(dpt, desc_at(kmajor, voff + (kk >> 2) * CH_BLK + (kk & 3) * 32),
                      desc_at(kmajor, da + off), kk);
    }
    wgmma_commit();
  };
  // dV [64 x HDP] += bf16(P^T) dO and dK += bf16(dS^T) Q of tile i, half
  // h (fragments pa[h], sa[h]), dO and Q [32 queries x HDP] MN-major,
  // issued and committed
  auto issue_dkv = [&](int i, int h) {
    const int s = i % STAGES;
    const int qa = Lo::SA + s * Lo::STR + h * 32 * 128;
    const int da = Lo::SB + s * Lo::STR + h * 32 * 128;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        fence_operand(dv[c][j]);
        fence_operand(dk[c][j]);
      }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_rs<64, 1>(dv[c], pa[h][kk], desc_at(mnmajor, da + c * CH_TN + kk * 2048));
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_rs<64, 1>(dk[c], sa[h][kk], desc_at(mnmajor, qa + c * CH_TN + kk * 2048));
    wgmma_commit();
  };
  // P^T = exp(s scale - lse[q]) where kept and dS^T = P^T (dP^T -
  // delta[q]) scale of tile i, half h, rounded into pa[h], sa[h]. Element x
  // of slice kk is st[8 kk + x]: key kj0 (x & 2 == 0) or kj1, query q0 +
  // 32 h + 8 j + 2 t + (x & 1), j = 2 kk + x / 4. lse in log2 units is
  // -inf on a fully masked row, whose entries are all selected to zero.
  auto form = [&](int i, int h) {
    const int s = i % STAGES, q0 = (qt_begin + i) * TN;
    const bool need_mask = q0 < k0 + BLK - 1 || k0 < pad || q0 + TN > L;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      fence_operand(st[j]);
      fence_operand(dpt[j]);
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      float p[8], ds[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int c = 32 * h + 8 * (2 * kk + (x >> 2)) + 2 * t + (x & 1);
        float pv = ex2(st[8 * kk + x] * a.scale_log2 - ls[s * TN + c] * LOG2E);
        if (need_mask) {
          const int qi = q0 + c;
          const bool keep = qi < L && (x & 2 ? kok1 && kj1 <= qi : kok0 && kj0 <= qi);
          pv = keep ? pv : 0.f;
        }
        p[x] = pv;
        ds[x] = pv * (dpt[8 * kk + x] - dls[s * TN + c]) * a.scale;
      }
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        pa[h][kk][y] = pack_bf16(p[2 * y], p[2 * y + 1]);
        sa[h][kk][y] = pack_bf16(ds[2 * y], ds[2 * y + 1]);
      }
    }
  };
  auto settle = [&]() {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        fence_operand(dv[c][j]);
        fence_operand(dk[c][j]);
      }
  };
  // tile i - 1's stage is done with in this warp; warp 4 (warpgroup 1,
  // which issues after warpgroup 0) refills it with tile i - 1 + STAGES
  // once every warp is
  auto release = [&](int i) {
    const int s = (i - 1) % STAGES;
    if (lane == 0) mbar_arrive(&empty[s]);
    if (loader && i - 1 + STAGES < n_tiles) {
      mbar_wait(&empty[s], ((i - 1) / STAGES) & 1);
      load_tile(i - 1 + STAGES);
    }
  };
  // One issue point a half tile, as the forward: S^T and dP^T of a half
  // are issued with the previous half's dV and dK products and formed into
  // fragments while those run; the two warpgroups take turns to issue
  // (named barriers 1 and 2, warpgroup 0 first).
  auto half = [&](int i, int h, int ip, int hp) {  // this half, the previous
    named_bar_sync(1 + w, NTHREADS);
    issue_s(i, h);
    issue_dkv(ip, hp);
    named_bar_arrive(2 - w, NTHREADS);
    wgmma_wait<1>();  // S^T, dP^T; the previous half's products may still run
    form(i, h);
    wgmma_wait<0>();
    settle();
  };

  if (n_tiles > 0) {
    mbar_wait(rfull, 0);
    mbar_wait(&full[0], 0);
    if (w == 1) named_bar_arrive(1, NTHREADS);
    named_bar_sync(1 + w, NTHREADS);
    issue_s(0, 0);
    named_bar_arrive(2 - w, NTHREADS);
    wgmma_wait<0>();
    form(0, 0);
    half(0, 1, 0, 0);
    for (int i = 1; i < n_tiles; ++i) {
      mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
      half(i, 0, i - 1, 1);
      release(i);
      half(i, 1, i, 0);
    }
    named_bar_sync(1 + w, NTHREADS);
    issue_dkv(n_tiles - 1, 1);
    if (w == 0) named_bar_arrive(2, NTHREADS);  // warpgroup 1 issues last
    wgmma_wait<0>();
    settle();
  }
  const size_t base = (size_t)bh * L * a.hd;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    store_rows<64>(a.dk + base + 64 * c, dk[c], kj0, L, a.hd - 64 * c, a.hd, t);
    store_rows<64>(a.dv + base + 64 * c, dv[c], kj0, L, a.hd - 64 * c, a.hd, t);
  }
}

template <int NC>
int launch(const void* q, const void* k, const void* v, const void* dout, const Args& a, int BH,
           cudaStream_t st) {
  const int L = a.L, hd = a.hd;
  CUtensorMap q_blk, do_blk, k_tn, v_tn, k_blk, v_blk, q_tn, do_tn;
  if (!bf16_batch_map(&q_blk, q, BH, L, hd, BLK) || !bf16_batch_map(&do_blk, dout, BH, L, hd, BLK) ||
      !bf16_batch_map(&k_tn, k, BH, L, hd, TN) || !bf16_batch_map(&v_tn, v, BH, L, hd, TN) ||
      !bf16_batch_map(&k_blk, k, BH, L, hd, BLK) || !bf16_batch_map(&v_blk, v, BH, L, hd, BLK) ||
      !bf16_batch_map(&q_tn, q, BH, L, hd, TN) || !bf16_batch_map(&do_tn, dout, BH, L, hd, TN))
    return (int)cudaErrorInvalidValue;
  const int bytes = Layout<NC>::BYTES;
  const dim3 grid(BH, (L + BLK - 1) / BLK);
  const void* kernels[2] = {(const void*)dq_kernel<NC>, (const void*)dkv_kernel<NC>};
  for (const void* kern : kernels) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dq_kernel<NC><<<grid, NTHREADS, bytes, st>>>(q_blk, do_blk, k_tn, v_tn, a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkv_kernel<NC><<<grid, NTHREADS, bytes, st>>>(k_blk, v_blk, q_tn, do_tn, a);
  return (int)cudaGetLastError();
}

}  // namespace anyref_bwd

// q, k, v, dout, dq, dk, dv contiguous bf16 [B, nh, L, hd], 16-byte
// aligned, hd a multiple of 8 up to 128 (ops/flash.py pads other widths);
// lse and delta [B, nh, L] fp32; kv_start [B] int32 or null.
ANYREF_API int anyref_causal_attention_bwd(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           const void* kv_start, void* dq, void* dk, void* dv,
                                           int B, int nh, int L, int hd, float scale,
                                           void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (nh <= 0 || hd <= 0 || hd > 128 || hd % 8) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16)
    return (int)cudaErrorMisalignedAddress;
  anyref_bwd::Args a = {};
  a.kv_start = (const int*)kv_start;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.dq = (bf16*)dq;
  a.dk = (bf16*)dk;
  a.dv = (bf16*)dv;
  a.nh = nh;
  a.L = L;
  a.hd = hd;
  a.scale = scale;
  a.scale_log2 = scale * anyref_bwd::LOG2E;
  const auto f = hd <= 64 ? anyref_bwd::launch<1> : anyref_bwd::launch<2>;
  return f(q, k, v, dout, a, B * nh, (cudaStream_t)stream);
}
