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
// the forward's saved log-sum-exp, zero where the causal or pad mask drops
// the key; dP = dO V^T in fp32 (bf16 products are exact in fp32, so the
// tensor cores' fp32 accumulation is the reference's fp32 product);
// dS = p * (dP - delta) * scale with delta = rowsum(dO * O) from the wrapper,
// as the reference's wrapper computes it; dQ = bf16(dS) K and
// dK = bf16(dS^T) Q, rounded to bf16 as the reference rounds them. One
// difference: the reference's dV = P^T dO is fp32 x fp32; here P^T is
// rounded to bf16 for the tensor cores (one bf16 rounding of P, within the
// tolerance chip_smoke.py holds the kernel to against the plain version).
// A fully masked (left-pad) query row contributes zero, as in the
// reference; its lse is -FLT_MAX, and a masked entry is selected to zero,
// never multiplied, so exp(s - lse) = inf there cannot become NaN.
//
// Bound on the H100: tensor-core operations, 10 * hd per kept (query, key)
// pair (S recomputed, dP, dV, dQ, dK). Design: mma.sync m16n8k16 with bf16
// operands and fp32 accumulators, as the forward (attention.cuh); tiles
// copied with cp.async, two deep. Tiles wholly above the diagonal or before
// the pad are skipped (every entry there is masked to zero).
// - dq: a block owns 64 query rows (four warps of 16) and keeps Q and dO in
//   shared memory, fragments read per use; per 64-key tile a warp forms S and
//   dP (2 x 32 fp32 registers), turns them into dS in place and adds
//   bf16(dS) K to its 16 x hd fp32 accumulator (K read with ldmatrix.trans).
// - dkv: a block owns 64 keys (four warps of 16) and keeps K and V in shared
//   memory; it walks query tiles of 32 (a smaller tile than the forward's:
//   the two 16 x hd fp32 accumulators of dK and dV already take 128
//   registers a thread at hd = 128), forming S^T = K Q^T and dP^T = V dO^T,
//   then dV += bf16(P^T) dO and dK += bf16(dS^T) Q. The tile's lse and delta
//   come with it into shared memory.
#include "attention.cuh"

namespace anyref_bwd {

using anyref_attn::NTHREADS;
constexpr int BQ = 64;   // dq: query rows per block
constexpr int BK = 64;   // dq: keys per tile; dkv: keys per block
constexpr int BQD = 32;  // dkv: queries per tile

struct Args {
  const bf16 *q, *k, *v, *dout;  // [B*nh, L, hd] contiguous
  const float *lse, *delta;      // [B*nh, L]
  const int* kv_start;           // [B] or null
  bf16 *dq, *dk, *dv;            // [B*nh, L, hd]
  int nh, L, hd;
  float scale;
  int vec;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows (r0, r0 + 8), k-slice ks of a [rows][ldh] tile.
__device__ __forceinline__ void frag_a(uint32_t* f, const bf16* t, int r0, int ldh, int col) {
  const bf16* p0 = t + r0 * ldh + col;
  const bf16* p1 = p0 + 8 * ldh;
  f[0] = ld32(p0);
  f[1] = ld32(p1);
  f[2] = ld32(p0 + 8);
  f[3] = ld32(p1 + 8);
}

template <int NKS>
__global__ void __launch_bounds__(NTHREADS) dq_kernel(const Args a) {
  constexpr int HDP = NKS * 16, LDH = HDP + 8, NDT = 2 * NKS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BQ][LDH]
  bf16* Ds = Qs + BQ * LDH;                  // dO [BQ][LDH]
  bf16* Ks = Ds + BQ * LDH;                  // [2][BK][LDH]
  bf16* Vs = Ks + 2 * BK * LDH;              // [2][BK][LDH]

  const int L = a.L, hd = a.hd;
  const int bh = blockIdx.y, b = bh / a.nh, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const size_t base = (size_t)bh * L * hd;
  const bf16 *qb = a.q + base, *kb = a.k + base, *vb = a.v + base, *db = a.dout + base;
  const int pad = a.kv_start ? a.kv_start[b] : 0;

  // key tiles not wholly before the pad nor above the diagonal; a block of
  // rows wholly inside the pad walks none (dq = 0)
  const int kt_begin = pad / BK;
  int kt_end = (q0 + BQ - 1) / BK + 1;
  const int nkt = (L + BK - 1) / BK;
  if (kt_end > nkt) kt_end = nkt;

  const int r0 = warp * 16 + g;
  const int qi0 = q0 + r0, qi1 = qi0 + 8;
  const float lse0 = qi0 < L ? a.lse[(size_t)bh * L + qi0] : 0.f;
  const float lse1 = qi1 < L ? a.lse[(size_t)bh * L + qi1] : 0.f;
  const float dl0 = qi0 < L ? a.delta[(size_t)bh * L + qi0] : 0.f;
  const float dl1 = qi1 < L ? a.delta[(size_t)bh * L + qi1] : 0.f;

  float acc[NDT][4];
#pragma unroll
  for (int i = 0; i < NDT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  if (kt_begin < kt_end) {
    anyref_attn::load_tile<BQ>(Qs, qb, q0, L, hd, hd, HDP, LDH, a.vec);
    anyref_attn::load_tile<BQ>(Ds, db, q0, L, hd, hd, HDP, LDH, a.vec);
    anyref_attn::load_tile<BK>(Ks, kb, kt_begin * BK, L, hd, hd, HDP, LDH, a.vec);
    anyref_attn::load_tile<BK>(Vs, vb, kt_begin * BK, L, hd, hd, HDP, LDH, a.vec);
    cp_async_commit();
  }
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      anyref_attn::load_tile<BK>(Ks + (st ^ 1) * BK * LDH, kb, (kt + 1) * BK, L, hd, hd, HDP, LDH,
                                 a.vec);
      anyref_attn::load_tile<BK>(Vs + (st ^ 1) * BK * LDH, vb, (kt + 1) * BK, L, hd, hd, HDP, LDH,
                                 a.vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + st * BK * LDH;
    const bf16* Vt = Vs + st * BK * LDH;
    const int k0 = kt * BK;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows and the 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      uint32_t qa[4], da[4];
      frag_a(qa, Qs, r0, LDH, ks * 16 + tig * 2);
      frag_a(da, Ds, r0, LDH, ks * 16 + tig * 2);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* kp = Kt + (nt * 8 + g) * LDH + ks * 16 + tig * 2;
        mma16816(s[nt], qa, ld32(kp), ld32(kp + 8));
        const bf16* vp = Vt + (nt * 8 + g) * LDH + ks * 16 + tig * 2;
        mma16816(dp[nt], da, ld32(vp), ld32(vp + 8));
      }
    }
    // dS = p * (dP - delta) * scale, p = exp(s * scale - lse) where kept
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + nt * 8 + tig * 2 + e;
        const bool kok = kj < L && kj >= pad;
        const float p0 = (kok && kj <= qi0) ? __expf(s[nt][e] * a.scale - lse0) : 0.f;
        const float p1 = (kok && kj <= qi1) ? __expf(s[nt][2 + e] * a.scale - lse1) : 0.f;
        s[nt][e] = p0 * (dp[nt][e] - dl0) * a.scale;
        s[nt][2 + e] = p1 * (dp[nt][2 + e] - dl1) * a.scale;
      }
    }
    // dQ += bf16(dS) K: keys in four slices of 16, K read transposed
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const int krow = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dt = 0; dt < NKS; ++dt) {
        uint32_t bk[4];
        ldsm_x4_trans(bk, Kt + krow * LDH + dt * 16 + (lane >> 4) * 8);
        mma16816(acc[2 * dt], pa, bk[0], bk[1]);
        mma16816(acc[2 * dt + 1], pa, bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  bf16* dqb = a.dq + base;
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = dt * 8 + tig * 2 + e;
      if (d < hd) {
        if (qi0 < L) dqb[(size_t)qi0 * hd + d] = __float2bfloat16(acc[dt][e]);
        if (qi1 < L) dqb[(size_t)qi1 * hd + d] = __float2bfloat16(acc[dt][2 + e]);
      }
    }
  }
}

// One query tile of the dkv kernel (Q, dO, lse, delta) into stage memory.
template <int HDP, int LDH>
__device__ __forceinline__ void load_query_tile(const Args& a, size_t base, int bh, int qt,
                                                bf16* Qt, bf16* Dt, float* Lt, float* Dlt) {
  const int q0 = qt * BQD, L = a.L;
  anyref_attn::load_tile<BQD>(Qt, a.q + base, q0, L, a.hd, a.hd, HDP, LDH, a.vec);
  anyref_attn::load_tile<BQD>(Dt, a.dout + base, q0, L, a.hd, a.hd, HDP, LDH, a.vec);
  if (threadIdx.x < BQD) {
    const int qi = q0 + threadIdx.x;
    Lt[threadIdx.x] = qi < L ? a.lse[(size_t)bh * L + qi] : 0.f;
    Dlt[threadIdx.x] = qi < L ? a.delta[(size_t)bh * L + qi] : 0.f;
  }
}

template <int NKS>
__global__ void __launch_bounds__(NTHREADS) dkv_kernel(const Args a) {
  constexpr int HDP = NKS * 16, LDH = HDP + 8, NDT = 2 * NKS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);              // [BK][LDH]
  bf16* Vs = Ks + BK * LDH;                              // [BK][LDH]
  bf16* Qs = Vs + BK * LDH;                              // [2][BQD][LDH]
  bf16* Ds = Qs + 2 * BQD * LDH;                         // dO [2][BQD][LDH]
  float* Ls = reinterpret_cast<float*>(Ds + 2 * BQD * LDH);  // lse [2][BQD]
  float* Dl = Ls + 2 * BQD;                              // delta [2][BQD]

  const int L = a.L, hd = a.hd;
  const int bh = blockIdx.y, b = bh / a.nh, k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const size_t base = (size_t)bh * L * hd;
  const int pad = a.kv_start ? a.kv_start[b] : 0;

  // query tiles at or below the diagonal (queries >= k0) and not before the
  // pad; a key block wholly before the pad is masked for every query
  const int qs = k0 > pad ? k0 : pad;
  const int qt_end = (L + BQD - 1) / BQD;
  const int qt_begin = k0 + BK <= pad ? qt_end : qs / BQD;

  const int kr0 = warp * 16 + g;
  const int kj0 = k0 + kr0, kj1 = kj0 + 8;
  const bool kok0 = kj0 >= pad, kok1 = kj1 >= pad;

  float dk[NDT][4], dv[NDT][4];
#pragma unroll
  for (int i = 0; i < NDT; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  if (qt_begin < qt_end) {
    anyref_attn::load_tile<BK>(Ks, a.k + base, k0, L, hd, hd, HDP, LDH, a.vec);
    anyref_attn::load_tile<BK>(Vs, a.v + base, k0, L, hd, hd, HDP, LDH, a.vec);
    load_query_tile<HDP, LDH>(a, base, bh, qt_begin, Qs, Ds, Ls, Dl);
    cp_async_commit();
  }
  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int st = (qt - qt_begin) & 1;
    if (qt + 1 < qt_end) {
      const int ns = st ^ 1;
      load_query_tile<HDP, LDH>(a, base, bh, qt + 1, Qs + ns * BQD * LDH, Ds + ns * BQD * LDH,
                                Ls + ns * BQD, Dl + ns * BQD);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + st * BQD * LDH;
    const bf16* Dt = Ds + st * BQD * LDH;
    const float* Lt = Ls + st * BQD;
    const float* Dlt = Dl + st * BQD;
    const int q0 = qt * BQD;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys and 32 queries
    float sT[4][4], dpT[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      sT[nt][0] = sT[nt][1] = sT[nt][2] = sT[nt][3] = 0.f;
      dpT[nt][0] = dpT[nt][1] = dpT[nt][2] = dpT[nt][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      uint32_t ka[4], va[4];
      frag_a(ka, Ks, kr0, LDH, ks * 16 + tig * 2);
      frag_a(va, Vs, kr0, LDH, ks * 16 + tig * 2);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* qp = Qt + (nt * 8 + g) * LDH + ks * 16 + tig * 2;
        mma16816(sT[nt], ka, ld32(qp), ld32(qp + 8));
        const bf16* dp = Dt + (nt * 8 + g) * LDH + ks * 16 + tig * 2;
        mma16816(dpT[nt], va, ld32(dp), ld32(dp + 8));
      }
    }
    // P^T = exp(s * scale - lse[q]) where kept; dS^T = P^T (dP^T - delta[q]) scale
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + tig * 2 + e, qi = q0 + c;
        const float lq = Lt[c], dlq = Dlt[c];
        const bool qok = qi < L;
        const float p0 = (qok && kok0 && kj0 <= qi) ? __expf(sT[nt][e] * a.scale - lq) : 0.f;
        const float p1 = (qok && kok1 && kj1 <= qi) ? __expf(sT[nt][2 + e] * a.scale - lq) : 0.f;
        sT[nt][e] = p0;
        sT[nt][2 + e] = p1;
        dpT[nt][e] = p0 * (dpT[nt][e] - dlq) * a.scale;
        dpT[nt][2 + e] = p1 * (dpT[nt][2 + e] - dlq) * a.scale;
      }
    }
    // dV += bf16(P^T) dO and dK += bf16(dS^T) Q: queries in two slices of
    // 16, dO and Q read transposed
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t pa[4], sa[4];
      pa[0] = pack_bf16(sT[2 * j][0], sT[2 * j][1]);
      pa[1] = pack_bf16(sT[2 * j][2], sT[2 * j][3]);
      pa[2] = pack_bf16(sT[2 * j + 1][0], sT[2 * j + 1][1]);
      pa[3] = pack_bf16(sT[2 * j + 1][2], sT[2 * j + 1][3]);
      sa[0] = pack_bf16(dpT[2 * j][0], dpT[2 * j][1]);
      sa[1] = pack_bf16(dpT[2 * j][2], dpT[2 * j][3]);
      sa[2] = pack_bf16(dpT[2 * j + 1][0], dpT[2 * j + 1][1]);
      sa[3] = pack_bf16(dpT[2 * j + 1][2], dpT[2 * j + 1][3]);
      const int row = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dt = 0; dt < NKS; ++dt) {
        uint32_t bt[4];
        ldsm_x4_trans(bt, Dt + row * LDH + dt * 16 + (lane >> 4) * 8);
        mma16816(dv[2 * dt], pa, bt[0], bt[1]);
        mma16816(dv[2 * dt + 1], pa, bt[2], bt[3]);
        ldsm_x4_trans(bt, Qt + row * LDH + dt * 16 + (lane >> 4) * 8);
        mma16816(dk[2 * dt], sa, bt[0], bt[1]);
        mma16816(dk[2 * dt + 1], sa, bt[2], bt[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  bf16* dkb = a.dk + base;
  bf16* dvb = a.dv + base;
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = dt * 8 + tig * 2 + e;
      if (d < hd) {
        if (kj0 < L) {
          dkb[(size_t)kj0 * hd + d] = __float2bfloat16(dk[dt][e]);
          dvb[(size_t)kj0 * hd + d] = __float2bfloat16(dv[dt][e]);
        }
        if (kj1 < L) {
          dkb[(size_t)kj1 * hd + d] = __float2bfloat16(dk[dt][2 + e]);
          dvb[(size_t)kj1 * hd + d] = __float2bfloat16(dv[dt][2 + e]);
        }
      }
    }
  }
}

template <int NKS>
inline int launch_nks(const Args& a, int BH, void* stream) {
  constexpr int LDH = NKS * 16 + 8;
  const int smem_dq = (2 * BQ + 4 * BK) * LDH * 2;
  const int smem_dkv = (2 * BK + 4 * BQD) * LDH * 2 + 4 * BQD * 4;
  cudaError_t e = cudaFuncSetAttribute(dq_kernel<NKS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dkv_kernel<NKS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_dkv);
  if (e != cudaSuccess) return (int)e;
  dq_kernel<NKS><<<dim3((a.L + BQ - 1) / BQ, BH), NTHREADS, smem_dq, (cudaStream_t)stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkv_kernel<NKS><<<dim3((a.L + BK - 1) / BK, BH), NTHREADS, smem_dkv, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace anyref_bwd

ANYREF_API int anyref_causal_attention_bwd(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           const void* kv_start, void* dq, void* dk, void* dv,
                                           int B, int nh, int L, int hd, float scale, int vec,
                                           void* stream) {
  if (B * nh <= 0 || L <= 0) return 0;
  if (nh <= 0) return (int)cudaErrorInvalidValue;
  anyref_bwd::Args a = {};
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.dout = (const bf16*)dout;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.kv_start = (const int*)kv_start;
  a.dq = (bf16*)dq;
  a.dk = (bf16*)dk;
  a.dv = (bf16*)dv;
  a.nh = nh;
  a.L = L;
  a.hd = hd;
  a.scale = scale;
  a.vec = vec;
  const int BH = B * nh;
#define ANYREF_NKS(n) \
  case n:             \
    return anyref_bwd::launch_nks<n>(a, BH, stream);
  switch ((hd + 15) / 16) {
    ANYREF_NKS(1) ANYREF_NKS(2) ANYREF_NKS(3) ANYREF_NKS(4)
    ANYREF_NKS(5) ANYREF_NKS(6) ANYREF_NKS(7) ANYREF_NKS(8)
    default:
      return (int)cudaErrorInvalidValue;  // hd > 128 (or <= 0)
  }
#undef ANYREF_NKS
}
