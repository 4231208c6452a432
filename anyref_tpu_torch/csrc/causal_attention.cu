// Causal attention with a per-row left pad (kv_start): the serving
// prefill and the forward of the training attention, one kernel.
//
// anyref_causal_attention replaces two kernels of anyref_tpu/ops/flash.py:
// - flash_causal_attention (the prefill; its multi-head kernel
//   _causal_mh_kernel and its per-(batch, head) kernel _causal_kernel).
//   Main-path shape [B, 32, L, 128], L = prompt bucket + 255 rounded up to
//   128 by the caller (384..768), lse null;
// - the forward of flash_causal_attention_diff (_causal_fwd_kernel), which
//   also writes each row's log-sum-exp [B * nh, L] fp32 for the backward
//   (causal_attention_bwd.cu). Main-path shape [2, 32, 768, 128]
//   (L = 512 + 255 padded to 768).
//
// What it computes, as the plain version causal_attention_diff_fwd_plain:
// fp32 scores; a key the causal or left-pad mask drops gets the finite
// logit float32.min, not -inf, so a fully masked (left-pad) query row ends
// as the mean of V over every key of the walk, never NaN; P = exp(s - m)
// is rounded to bf16 for the P V product and the sum divided by max(l,
// 1e-20) at the end; lse = m + log(max(l, 1e-20)) (float32.min for a fully
// masked row, as the reference's float32 gives it). Here the running max
// rescales P and O tile by tile (the plain version's P uses the row's
// final max: the two round P to bf16 at different scales).
//
// Bound on the H100: tensor-core operations, 4 hd per kept (query, key)
// pair (Q K^T and P V), 11.3 GFLOP at [2, 32, 768, 128] with the diagonal
// tiles (0.0114 ms at 989 TFLOP/s), against 0.015 ms for the bytes of q,
// k, v and out. Only wgmma reaches that rate. The design (FlashAttention-3's
// intra-warpgroup overlap, helpers in wgmma.cuh):
// - one block per (batch * head, 128-query tile), two warpgroups of 64
//   query rows, 256 threads (at most 8 warps a block leave a thread 255
//   registers: O, S and P together need more than the 168 of a 12-warp
//   producer / consumer split);
// - one thread issues every TMA load: Q once, then K and V in 128-key
//   tiles through a 3-stage ring, each tile on its own full barrier (S
//   starts before V has landed), a stage refilled once every warp has
//   arrived at its empty barrier; 128-byte swizzle, 64-column blocks, hd
//   zero-filled by TMA to 64 or 128 columns; rows past L read zero;
// - S = Q K^T: m64n128k16 RS wgmma, Q in registers (ldmatrix once, so
//   that the two warpgroups' products read only K from shared memory) and
//   K K-major; the scores stay in the accumulator registers, where the
//   online softmax runs (in log2 units, ex2; a row's max reduced over the
//   four lanes that share it);
// - P rounded to bf16 in registers becomes the A fragments of an RS wgmma
//   O += P V, V read MN-major (the transposed descriptor), the head width
//   as wgmma's N (64 or 128); tile i's softmax runs while tile i - 1's
//   P V is on the tensor cores, and the two warpgroups take turns to issue
//   their products (ping-pong), so that one's softmax runs beside the
//   other's products;
// - tiles wholly above the diagonal or before the pad are skipped for a
//   block with no fully masked row, because they add exactly zero to every
//   row; a block holding left-pad rows walks every tile. Only the tiles on
//   the diagonal, across the pad or past L pay for the mask. The grid
//   launches the longest query tiles (the last ones) of every head first,
//   so the causal tail does not end on a long block.
// 224 KB of shared memory at hd = 128: one block an SM.
#include <float.h>

#include "wgmma.cuh"

namespace anyref_causal {

constexpr int BM = 128, BN = 128;   // query rows a block, keys a tile
constexpr int STAGES = 3;           // K / V ring
constexpr int NTHREADS = 256;       // two warpgroups
constexpr int CHUNK = 128 * 128;    // bytes of one 64-column block of 128 rows
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// NC 64-column blocks of the head width (hd <= 64: 1, else 2).
template <int NC>
struct Layout {
  static constexpr int TILE = NC * CHUNK;
  static constexpr int Q = 0, K = TILE, V = K + STAGES * TILE, BAR = V + STAGES * TILE;
  static constexpr int BYTES = BAR + (1 + 3 * STAGES) * 8 + 1024;  // + slack to align
};

template <int NC>
__global__ void __launch_bounds__(NTHREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ kv_start,
               bf16* __restrict__ out, float* __restrict__ lse, int nh, int L, int hd,
               float scale_log2) {
  using Lo = Layout<NC>;
  constexpr int HDP = 64 * NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + Lo::BAR);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;  // one arrival per warp done with a stage

  const int bh = blockIdx.x, b = bh / nh;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest walks first
  const int q0 = qt * BM;
  const int pad = kv_start ? kv_start[b] : 0;
  const int nkt = (L + BN - 1) / BN;
  const bool walk_all = q0 < pad;  // a row of this block is fully masked
  const int kt_begin = walk_all ? 0 : pad / BN;
  const int n_tiles = (walk_all ? nkt : min(nkt, qt + 1)) - kt_begin;

  // K and V of tile i into stage i % STAGES, each on its full barrier
  auto load_kv = [&](int i) {
    const int s = i % STAGES, k0 = (kt_begin + i) * BN;
    mbar_arrive_expect_tx(&kfull[s], Lo::TILE);
    for (int c = 0; c < NC; ++c)
      tma_load_3d(smem + Lo::K + s * Lo::TILE + c * CHUNK, &tm_k, &kfull[s], 64 * c, k0, bh);
    mbar_arrive_expect_tx(&vfull[s], Lo::TILE);
    for (int c = 0; c < NC; ++c)
      tma_load_3d(smem + Lo::V + s * Lo::TILE + c * CHUNK, &tm_v, &vfull[s], 64 * c, k0, bh);
  };
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], NTHREADS / 32);
    }
    mbar_fence_init();
    mbar_arrive_expect_tx(qfull, Lo::TILE);
    for (int c = 0; c < NC; ++c)
      tma_load_3d(smem + Lo::Q + c * CHUNK, &tm_q, qfull, 64 * c, q0, bh);
    for (int i = 0; i < min(STAGES, n_tiles); ++i) load_kv(i);
  }
  __syncthreads();

  const int w = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's two query rows: accumulator rows g and g + 8 of its warp
  const int r0 = q0 + 64 * w + 16 * warp + g, r1 = r0 + 8;
  // descriptors of the block's shared memory, K-major and V's MN-major;
  // each wgmma's is this base plus a constant offset
  const uint64_t kmajor = sw128_desc(smem), mnmajor = sw128_mn_desc(smem, CHUNK);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float sc[64];
  uint32_t pa[8][4];
  uint32_t qa[4 * NC][4];  // the warpgroup's Q as the A fragments of S = Q K^T

  // S [64 x 128] = Q K^T of tile i into sc, issued and committed; Q from
  // registers, so that only K is read from shared memory
  auto issue_s = [&](int i) {
    const int s = i % STAGES;
    mbar_wait(&kfull[s], (i / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      const int off = (kk >> 2) * CHUNK + (kk & 3) * 32;
      wgmma_rs<128, 0>(sc, qa[kk], desc_at(kmajor, Lo::K + s * Lo::TILE + off), kk);
    }
    wgmma_commit();
  };
  // O [64 x HDP] += bf16(P) V of tile i, P in pa, V [128 keys x HDP]
  // MN-major, issued and committed
  auto issue_pv = [&](int i) {
    const int s = i % STAGES;
    mbar_wait(&vfull[s], (i / STAGES) & 1);
#pragma unroll
    for (int j = 0; j < HDP / 2; ++j) fence_operand(o[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs<HDP, 1>(o, pa[kk], desc_at(mnmajor, Lo::V + s * Lo::TILE + kk * 2048));
    wgmma_commit();
  };
  // tile i's scores in sc -> unnormalised P in sc (fp32); the running max
  // and sums move on, and a0 / a1 are the factors that rescale O's rows
  auto softmax = [&](int i, float& a0, float& a1) {
#pragma unroll
    for (int j = 0; j < 64; ++j) fence_operand(sc[j]);
    // scale to log2 units and mask; thread holds rows r0 (sc[4 j + e]) and
    // r1 (sc[4 j + 2 + e]) at keys k0 + 8 j + 2 t + e
    const int k0 = (kt_begin + i) * BN;
    const bool need_mask = k0 + BN - 1 > q0 || k0 < pad || k0 + BN > L;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v0 = sc[4 * j + e] * scale_log2, v1 = sc[4 * j + 2 + e] * scale_log2;
        if (need_mask) {
          const int kj = k0 + 8 * j + 2 * t + e;
          if (kj >= L) {
            v0 = v1 = -INFINITY;  // not a key at all: weight exactly 0
          } else {
            if (kj > r0 || kj < pad) v0 = -FLT_MAX;
            if (kj > r1 || kj < pad) v1 = -FLT_MAX;
          }
        }
        sc[4 * j + e] = v0;
        sc[4 * j + 2 + e] = v1;
        mx0 = fmaxf(mx0, v0);
        mx1 = fmaxf(mx1, v1);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // finite: key k0 < L. A row that has seen only dropped keys has max
    // float32.min, and exp2(float32.min - float32.min) = 1 weighs them all
    // alike until a kept key's max sends their weight to 0.
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    a0 = ex2(m0 - mn0);  // 0 on the first tile
    a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = ex2(sc[4 * j + e] - mn0);
        sc[4 * j + 2 + e] = ex2(sc[4 * j + 2 + e] - mn1);
        ps0 += sc[4 * j + e];
        ps1 += sc[4 * j + 2 + e];
      }
    }
    l0 = l0 * a0 + ps0;  // this lane's share of the row sums
    l1 = l1 * a1 + ps1;
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

  // tile i - 1's stage is done with in this warp; thread 128 (warpgroup 1,
  // which issues its products after warpgroup 0's) refills it with tile
  // i - 1 + STAGES once every warp is
  auto release = [&](int i) {
    const int s = (i - 1) % STAGES;
    if (lane == 0) mbar_arrive(&empty[s]);
    if (threadIdx.x == 128 && i - 1 + STAGES < n_tiles) {
      mbar_wait(&empty[s], ((i - 1) / STAGES) & 1);
      load_kv(i - 1 + STAGES);
    }
  };

  // Software pipeline (FlashAttention-3's intra-warpgroup overlap): while
  // P_{i-1} V_{i-1} runs on the tensor cores, S_i is waited for and turned
  // into P_i; O is rescaled only once the product into it has completed.
  // The two warpgroups take turns to issue (FlashAttention-3's ping-pong,
  // named barriers 1 and 2, warpgroup 0 first), so that one's softmax runs
  // while the other's products occupy the tensor cores.
  float a0, a1;
  mbar_wait(qfull, 0);
#pragma unroll
  for (int kk = 0; kk < 4 * NC; ++kk) sw128_frag(qa[kk], smem + Lo::Q + w * 64 * 128, CHUNK, kk);
  if (w == 1) named_bar_arrive(1, NTHREADS);
  named_bar_sync(1 + w, NTHREADS);
  issue_s(0);
  named_bar_arrive(2 - w, NTHREADS);  // the other's turn
  wgmma_wait<0>();
  softmax(0, a0, a1);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) acc_to_frag(sc, kk, pa[kk]);
  for (int i = 1; i < n_tiles; ++i) {
    named_bar_sync(1 + w, NTHREADS);
    issue_s(i);
    issue_pv(i - 1);
    named_bar_arrive(2 - w, NTHREADS);
    wgmma_wait<1>();  // S_i; P_{i-1} V_{i-1} may still run
    softmax(i, a0, a1);
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < HDP / 2; ++j) fence_operand(o[j]);
    release(i);
    rescale_o(a0, a1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) acc_to_frag(sc, kk, pa[kk]);
  }
  named_bar_sync(1 + w, NTHREADS);
  issue_pv(n_tiles - 1);
  if (w == 0) named_bar_arrive(2, NTHREADS);  // warpgroup 1 issues last
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < HDP / 2; ++j) fence_operand(o[j]);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // out = O / l; the clamp matches the reference's max(denom, 1e-20)
  l0 = fmaxf(l0, 1e-20f);
  l1 = fmaxf(l1, 1e-20f);
  if (lse && t == 0) {
    // m is in log2 units; a fully masked row's float32.min stays float32.min
    if (r0 < L) lse[(size_t)bh * L + r0] = m0 == -FLT_MAX ? -FLT_MAX : m0 * LN2 + logf(l0);
    if (r1 < L) lse[(size_t)bh * L + r1] = m1 == -FLT_MAX ? -FLT_MAX : m1 * LN2 + logf(l1);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  bf16* ob = out + (size_t)bh * L * hd;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int d = 8 * j + 2 * t;
    if (d < hd) {
      if (r0 < L)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * hd + d) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1 < L)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * hd + d) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

template <int NC>
int launch(const void* q, const void* k, const void* v, const int* kv_start, bf16* out,
           float* lse, int BH, int nh, int L, int hd, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!bf16_batch_map(&tq, q, BH, L, hd, BM) || !bf16_batch_map(&tk, k, BH, L, hd, BN) ||
      !bf16_batch_map(&tv, v, BH, L, hd, BN))
    return (int)cudaErrorInvalidValue;
  const void* kern = (const void*)fwd_kernel<NC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<NC>::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(BH, (L + BM - 1) / BM);
  fwd_kernel<NC><<<grid, NTHREADS, Layout<NC>::BYTES, st>>>(tq, tk, tv, kv_start, out, lse, nh,
                                                             L, hd, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace anyref_causal

// q, k, v, out contiguous bf16 [B, nh, L, hd], 16-byte aligned, hd a
// multiple of 8 up to 128 (ops/flash.py pads other widths); kv_start [B]
// int32 or null; lse [B, nh, L] fp32 or null.
ANYREF_API int anyref_causal_attention(const void* q, const void* k, const void* v,
                                       const void* kv_start, void* out, void* lse, int B,
                                       int nh, int L, int hd, float scale, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (nh <= 0 || hd <= 0 || hd > 128 || hd % 8) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorMisalignedAddress;
  const auto f = hd <= 64 ? anyref_causal::launch<1> : anyref_causal::launch<2>;
  return f(q, k, v, (const int*)kv_start, (bf16*)out, (float*)lse, B * nh, nh, L, hd, scale,
           (cudaStream_t)stream);
}
