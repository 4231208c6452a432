// Flash attention core shared by the port's attention kernels: rel-pos
// (SAM, bias factors given or built in the kernel), causal (LLaMA prefill)
// and bias-free (CLIP). Head (b, h) of q, k, v and out is a bf16 [L, hd]
// matrix whose row r lies at base + b * sb + h * sh + r * sr (elements), so
// one kernel reads split heads [B, nh, L, hd] or column slices of a fused
// [B, L, 3C] QKV tensor ("QKV-direct"), and writes split heads or the
// head-merged [B, L, C] stream.
//
// What bounds it on the H100: the two products (Q K^T and P V) are
// 4 * BH * L^2 * hd operations; at L = 4096 that work, not the bytes of
// q/k/v/out, sets the least time, and at the window, CLIP and prefill shapes
// the bytes do. The design keeps the score matrix out of device memory and
// out of shared memory:
// - a block owns BQ = 64 query rows, four warps of 16; a warp keeps its Q
//   fragments, its 16 x 64 scores and its 16 x hd output accumulator in
//   registers, in the layouts of the tensor cores' mma.sync.m16n8k16
//   (bf16 in, fp32 accumulate);
// - keys are walked in tiles of BK = 64, copied to shared memory with
//   cp.async two tiles deep, so the next tile loads while this one is
//   computed; an online softmax (running max and sum per row, reduced over
//   the four lanes that share a row) means a row of scores never has to
//   fit at once. The TPU kernels kept whole [L, L] or [256, 4096] fp32
//   score blocks in VMEM; a block here has at most 227 KB of shared memory;
// - the scores become the A operand of the P V product in registers (the
//   accumulator layout of two 8-wide tiles is the operand layout of one
//   16-wide slice), and V is read transposed by ldmatrix.trans.
// The head width is padded with zeros in shared memory to a multiple of 16
// (hd = 80 stays 80; any hd <= 128 runs), and keys and queries past L are
// zero rows whose scores are excluded, so any L runs (L = 196, 257).
// Scores, softmax and the running sums are fp32; P is rounded to bf16 for
// the P V product, and the output is divided by the row sum at the end (the
// reference's fused kernels divide P before rounding it: one bf16 rounding
// of P apart).
//
// Bias modes:
// - RELPOS: rh [BH, L, H] and rw [BH, L, W] fp32 factors from the wrapper;
//   bias[q, key] = rh[q, key / W] + rw[q, key % W]. The block keeps its 64
//   rows of both in shared memory (odd row stride) and adds them per key.
// - WINDOW: the same bias, with the factors built in the kernel from the
//   gathered bf16 tables th, tw [ws, ws, hd] and the block's bf16 Q:
//   rh[q, j] = q . th[q / ws, j], rw[q, j] = q . tw[q % ws, j] in fp32, as
//   _window_attn_all computes them inside the TPU kernel.
// - CAUSAL: a key the causal or left-pad mask drops gets the finite logit
//   -FLT_MAX (float32.min), not -inf, as the reference masks. A query row
//   whose keys are all dropped (a left-pad row) therefore ends as the
//   uniform mean of V over every key of the walk, as the plain version
//   gives, and never NaN. Key tiles above the diagonal (or before the pad)
//   are skipped only when no row of the block is fully masked, because for
//   any other row those tiles add exactly zero. With the template flag LSE
//   (the training forward) each row also writes its log-sum-exp
//   m + log(max(l, 1e-20)) in fp32 to lse [BH, L], as the reference's
//   _causal_fwd_kernel does; a fully masked row's is -FLT_MAX + log(L),
//   which rounds to -FLT_MAX there too.
// - NONE: plain softmax attention.
#pragma once

#include <float.h>

#include "common.cuh"

namespace anyref_attn {

constexpr int BQ = 64, BK = 64, NWARPS = 4, NTHREADS = 32 * NWARPS;
enum Mode { CAUSAL = 0, RELPOS = 1, NONE = 2, WINDOW = 3 };

// Row r of head h of batch entry b lies at base + b * sb + h * sh + r * sr
// (32-bit strides, widened to 64 bits as they are multiplied).
struct View {
  int sb, sh, sr;
};

struct Args {
  const bf16 *q, *k, *v;  // q, k and v share `in`
  View in;
  bf16* out;
  View outv;
  int nh, L, hd;
  float scale;
  int vec;               // 16-byte copies: hd, strides and bases multiples of 8 elements
  int H, W;              // RELPOS / WINDOW: the key grid (WINDOW: H = W = ws)
  const float *rh, *rw;  // RELPOS factors
  const bf16 *th, *tw;   // WINDOW tables
  const int* kv_start;   // CAUSAL left pad per batch entry, or null
  float* lse;            // CAUSAL with LSE: [BH, L] fp32 out
};

struct Layout {
  int hdp, ldh, ldrh, ldrw;
  size_t q, k, v, rh, rw, kh, kw, total;
};

// Row stride of a bias-factor table in shared memory: odd, so the eight
// rows a warp reads at one key fall in eight different banks (at H = 64 an
// even stride put all eight in one bank).
__host__ __device__ inline int odd_stride(int n) { return n % 2 ? n : n + 1; }

__host__ __device__ inline size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

// Shared memory: Q [64][ldh], K and V [2 stages][64][ldh] (bf16, ldh = hdp
// + 8 so the fragment loads of eight rows hit eight distinct banks), and for
// the rel-pos modes the block's rows of the bias factors ([64][ldrh],
// [64][ldrw]) and one tile's key -> (row, column) tables.
__host__ __device__ inline Layout make_layout(int hd, int H, int W) {
  Layout t;
  t.hdp = (hd + 15) / 16 * 16;
  t.ldh = t.hdp + 8;
  t.ldrh = odd_stride(H);
  t.ldrw = odd_stride(W);
  size_t off = 0;
  t.q = off; off += align128((size_t)BQ * t.ldh * 2);
  t.k = off; off += align128((size_t)2 * BK * t.ldh * 2);
  t.v = off; off += align128((size_t)2 * BK * t.ldh * 2);
  t.rh = off; off += align128((size_t)BQ * t.ldrh * 4);
  t.rw = off; off += align128((size_t)BQ * t.ldrw * 4);
  t.kh = off; off += align128((size_t)BK * 4);
  t.kw = off; off += align128((size_t)BK * 4);
  t.total = off;
  return t;
}

// rows [row0, row0 + ROWS) x cols [0, hdp) of an [L, hd] matrix with row
// stride ld into shared memory with leading dimension lds; zero outside
// [0, L) x [0, hd). With `vec` the copy is asynchronous.
template <int ROWS = 64>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int L, int hd,
                                          int ld, int hdp, int lds, int vec) {
  if (vec) {
    const int vpr = hdp / 8;
    for (int i = threadIdx.x; i < ROWS * vpr; i += NTHREADS) {
      const int r = i / vpr, c = (i % vpr) * 8;
      const bool ok = row0 + r < L && c < hd;
      cp_async16(dst + r * lds + c, ok ? src + (size_t)(row0 + r) * ld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * hdp; i += NTHREADS) {
      const int r = i / hdp, c = i % hdp;
      dst[r * lds + c] = (row0 + r < L && c < hd) ? src[(size_t)(row0 + r) * ld + c]
                                                   : __float2bfloat16(0.f);
    }
  }
}

// NKS = padded hd / 16; LSE (CAUSAL only) also writes each row's
// log-sum-exp.
template <int MODE, int NKS, bool LSE = false>
__global__ void __launch_bounds__(NTHREADS) attn_kernel(const Args a) {
  constexpr bool BIAS = MODE == RELPOS || MODE == WINDOW;
  constexpr int HDP = NKS * 16, LDH = HDP + 8, NDT = 2 * NKS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = a.L, hd = a.hd, H = BIAS ? a.H : 0, W = BIAS ? a.W : 0;
  const Layout t = make_layout(hd, H, W);
  bf16* Qs = reinterpret_cast<bf16*>(smem + t.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + t.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + t.v);
  float* Rh = reinterpret_cast<float*>(smem + t.rh);
  float* Rw = reinterpret_cast<float*>(smem + t.rw);
  int* Kh = reinterpret_cast<int*>(smem + t.kh);
  int* Kw = reinterpret_cast<int*>(smem + t.kw);

  const int bh = blockIdx.y, b = bh / a.nh, h = bh % a.nh, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group, lane in group
  const size_t ibase = (size_t)b * a.in.sb + (size_t)h * a.in.sh;
  const bf16* qb = a.q + ibase;
  const bf16* kb = a.k + ibase;
  const bf16* vb = a.v + ibase;
  bf16* ob = a.out + (size_t)b * a.outv.sb + (size_t)h * a.outv.sh;
  const int ld = a.in.sr;

  int pad = 0;
  if (MODE == CAUSAL) {
    pad = a.kv_start ? a.kv_start[b] : 0;
  } else if (MODE == RELPOS) {
    for (int i = tid; i < BQ * H; i += NTHREADS) {
      const int r = i / H, j = i % H;
      Rh[r * t.ldrh + j] = q0 + r < L ? a.rh[((size_t)bh * L + q0 + r) * H + j] : 0.f;
    }
    for (int i = tid; i < BQ * W; i += NTHREADS) {
      const int r = i / W, j = i % W;
      Rw[r * t.ldrw + j] = q0 + r < L ? a.rw[((size_t)bh * L + q0 + r) * W + j] : 0.f;
    }
  }

  int kt_begin = 0, kt_end = (L + BK - 1) / BK;
  if (MODE == CAUSAL && q0 >= pad) {
    // no row of this block is fully masked: tiles wholly before the pad or
    // above the diagonal contribute exactly zero to every row
    kt_begin = pad / BK;
    const int last = (q0 + BQ - 1) / BK + 1;
    kt_end = last < kt_end ? last : kt_end;
  }

  // group 0: Q and the first K/V tile
  load_tile(Qs, qb, q0, L, hd, ld, HDP, LDH, a.vec);
  load_tile(Ks, kb, kt_begin * BK, L, hd, ld, HDP, LDH, a.vec);
  load_tile(Vs, vb, kt_begin * BK, L, hd, ld, HDP, LDH, a.vec);
  cp_async_commit();

  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this lane's two rows in the block
  const int qi0 = q0 + r0, qi1 = q0 + r1;     // and their query positions
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[NDT][4];
#pragma unroll
  for (int i = 0; i < NDT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  uint32_t qa[NKS][4];

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      load_tile(Ks + (st ^ 1) * BK * LDH, kb, (kt + 1) * BK, L, hd, ld, HDP, LDH, a.vec);
      load_tile(Vs + (st ^ 1) * BK * LDH, vb, (kt + 1) * BK, L, hd, ld, HDP, LDH, a.vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int k0 = kt * BK;
    if (BIAS && tid < BK) {
      Kh[tid] = (k0 + tid) / W;
      Kw[tid] = (k0 + tid) % W;
    }
    __syncthreads();
    if (kt == kt_begin) {
      if (MODE == WINDOW) {
        // the block's rows of the bias factors, from its bf16 Q (now in
        // shared memory) and the bf16 tables, summed in fp32
        for (int i = tid; i < BQ * (H + W); i += NTHREADS) {
          const int r = i / (H + W), j = i % (H + W), qi = q0 + r;
          float acc = 0.f;
          if (qi < L) {
            const bf16* tab = j < H ? a.th + ((size_t)(qi / W) * H + j) * hd
                                    : a.tw + ((size_t)(qi % W) * W + (j - H)) * hd;
            const bf16* qr = Qs + r * LDH;
            if (a.vec) {
              for (int d = 0; d < hd; d += 8) {
                float x[8], y[8];
                load8(qr + d, x);
                load8(tab + d, y);
#pragma unroll
                for (int e = 0; e < 8; ++e) acc += x[e] * y[e];
              }
            } else {
              for (int d = 0; d < hd; ++d) acc += __bfloat162float(qr[d]) * __bfloat162float(tab[d]);
            }
          }
          if (j < H) Rh[r * t.ldrh + j] = acc;
          else Rw[r * t.ldrw + (j - H)] = acc;
        }
        __syncthreads();
      }
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        const bf16* p0 = Qs + r0 * LDH + ks * 16 + tig * 2;
        const bf16* p1 = Qs + r1 * LDH + ks * 16 + tig * 2;
        qa[ks][0] = *reinterpret_cast<const uint32_t*>(p0);
        qa[ks][1] = *reinterpret_cast<const uint32_t*>(p1);
        qa[ks][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
        qa[ks][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
      }
    }
    const bf16* Kt = Ks + st * BK * LDH;
    const bf16* Vt = Vs + st * BK * LDH;

    // S [16 rows of this warp, 64 keys] = Q K^T, eight 16x8 tiles
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* kp = Kt + (nt * 8 + g) * LDH + ks * 16 + tig * 2;
        mma16816(s[nt], qa[ks], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // scale, bias or mask; online softmax over the tile. Lane holds rows r0
    // (s[.][0..1]) and r1 (s[.][2..3]) at keys nt * 8 + tig * 2 + {0, 1}.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + tig * 2 + e, kj = k0 + c;
        float v0 = s[nt][e] * a.scale, v1 = s[nt][2 + e] * a.scale;
        if (kj >= L) {
          v0 = v1 = -INFINITY;  // not a key at all: weight exactly 0
        } else if (MODE == CAUSAL) {
          if (kj > qi0 || kj < pad) v0 = -FLT_MAX;
          if (kj > qi1 || kj < pad) v1 = -FLT_MAX;
        } else if (BIAS) {
          const int kh = Kh[c], kw = Kw[c];
          v0 += Rh[r0 * t.ldrh + kh] + Rw[r0 * t.ldrw + kw];
          v1 += Rh[r1 * t.ldrh + kh] + Rw[r1 * t.ldrw + kw];
        }
        s[nt][e] = v0;
        s[nt][2 + e] = v1;
        mx0 = fmaxf(mx0, v0);
        mx1 = fmaxf(mx1, v1);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: key k0 < L
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);  // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = __expf(s[nt][e] - mn0);
        s[nt][2 + e] = __expf(s[nt][2 + e] - mn1);
        ps0 += s[nt][e];
        ps1 += s[nt][2 + e];
      }
    }
    // per-lane partial sums; the four lanes of a row share alpha
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      o[dt][0] *= a0;
      o[dt][1] *= a0;
      o[dt][2] *= a1;
      o[dt][3] *= a1;
    }

    // O [16, hdp] += P V: keys in four slices of 16, head dims in pairs of
    // 8-wide tiles; V fragments come from ldmatrix.trans of row-major V
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const int vrow = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < NKS; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, Vt + vrow * LDH + dp * 16 + (lane >> 4) * 8);
        mma16816(o[2 * dp], pa, bv[0], bv[1]);
        mma16816(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // out = O / l; the clamp matches the reference's max(denom, 1e-20)
  l0 = fmaxf(l0, 1e-20f);
  l1 = fmaxf(l1, 1e-20f);
  if (LSE && tig == 0) {
    if (qi0 < L) a.lse[(size_t)bh * L + qi0] = m0 + logf(l0);
    if (qi1 < L) a.lse[(size_t)bh * L + qi1] = m1 + logf(l1);
  }
  const int osr = a.outv.sr;
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = dt * 8 + tig * 2 + e;
      if (d < hd) {
        if (qi0 < L) ob[(size_t)qi0 * osr + d] = __float2bfloat16(o[dt][e] / l0);
        if (qi1 < L) ob[(size_t)qi1 * osr + d] = __float2bfloat16(o[dt][2 + e] / l1);
      }
    }
  }
}

template <int MODE, int NKS, bool LSE>
inline int launch_nks(const Args& a, int BH, void* stream) {
  const bool bias = MODE == RELPOS || MODE == WINDOW;
  const Layout t = make_layout(a.hd, bias ? a.H : 0, bias ? a.W : 0);
  cudaError_t e = cudaFuncSetAttribute(attn_kernel<MODE, NKS, LSE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)t.total);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.L + BQ - 1) / BQ, BH);
  attn_kernel<MODE, NKS, LSE><<<grid, NTHREADS, t.total, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Launch over BH = B * nh heads; the kernel runs any hd in [1, 128].
template <int MODE, bool LSE = false>
inline int launch(const Args& a, int BH, void* stream) {
  if (BH <= 0 || a.L <= 0) return 0;
  if (a.nh <= 0) return (int)cudaErrorInvalidValue;
#define ANYREF_NKS(n) \
  case n:             \
    return launch_nks<MODE, n, LSE>(a, BH, stream);
  switch ((a.hd + 15) / 16) {
    ANYREF_NKS(1) ANYREF_NKS(2) ANYREF_NKS(3) ANYREF_NKS(4)
    ANYREF_NKS(5) ANYREF_NKS(6) ANYREF_NKS(7) ANYREF_NKS(8)
    default:
      return (int)cudaErrorInvalidValue;  // hd > 128 (or <= 0)
  }
#undef ANYREF_NKS
}

// Args for contiguous split heads [B, nh, L, hd] in and out.
inline Args split_heads(const void* q, const void* k, const void* v, void* out, int nh, int L,
                        int hd, float scale, int vec) {
  Args a = {};
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.out = (bf16*)out;
  a.in = View{nh * L * hd, L * hd, hd};
  a.outv = a.in;
  a.nh = nh;
  a.L = L;
  a.hd = hd;
  a.scale = scale;
  a.vec = vec;
  return a;
}

// Args for q/k/v read as column slices of a fused [B, L, 3C] tensor and the
// output written head-merged [B, L, C] (C = nh * hd).
inline Args qkv_direct(const void* qkv, void* out, int nh, int L, int hd, float scale, int vec) {
  const int C = nh * hd;
  Args a = {};
  a.q = (const bf16*)qkv;
  a.k = a.q + C;
  a.v = a.q + 2 * C;
  a.in = View{L * 3 * C, hd, 3 * C};
  a.out = (bf16*)out;
  a.outv = View{L * C, hd, C};
  a.nh = nh;
  a.L = L;
  a.hd = hd;
  a.scale = scale;
  a.vec = vec;
  return a;
}

}  // namespace anyref_attn
