// Flash attention core shared by the rel-pos (SAM) and causal (LLaMA
// prefill) kernels: q, k, v, out are [BH, L, hd] bf16, row-major.
//
// What bounds it on the H100: the two products (Q K^T and P V) are
// 4 * BH * L^2 * hd operations; at L = 4096 that work, not the bytes of
// q/k/v/out, sets the least time, and at the window and prefill shapes the
// bytes do. The design keeps the score matrix out of device memory and out
// of shared memory:
// - a block owns BQ = 64 query rows, four warps of 16; a warp keeps its Q
//   fragments, its 16 x 64 scores and its 16 x hd output accumulator in
//   registers, in the layouts of the tensor cores' mma.sync.m16n8k16
//   (bf16 in, fp32 accumulate);
// - keys are walked in tiles of BK = 64, copied to shared memory with
//   cp.async two tiles deep, so the next tile loads while this one is
//   computed; an online softmax (running max and sum per row, reduced over
//   the four lanes that share a row) means a row of scores never has to
//   fit at once. The TPU kernel kept a whole [256, 4096] fp32 score block
//   in VMEM; a block here has at most 227 KB of shared memory;
// - the scores become the A operand of the P V product in registers (the
//   accumulator layout of two 8-wide tiles is the operand layout of one
//   16-wide slice), and V is read transposed by ldmatrix.trans.
// The head width is padded with zeros in shared memory to a multiple of 16
// (hd = 80 stays 80; any hd <= 128 runs), and keys and queries past L are
// zero rows whose scores are excluded, so any L runs.
// Scores, softmax and the running sums are fp32; P is rounded to bf16 for
// the P V product, as the reference rounds p to v's dtype.
//
// Masking follows the reference exactly: a key the causal or left-pad mask
// drops gets the finite logit -FLT_MAX (float32.min), not -inf. A query row
// whose keys are all dropped (a left-pad row) therefore ends as the uniform
// mean of V over every key of the walk, as the plain version gives, and
// never NaN. The causal kernel only skips key tiles above the diagonal (or
// before the pad) when no row of the block is fully masked, because for any
// other row those tiles add exactly zero.
#pragma once

#include <float.h>

#include "common.cuh"

namespace anyref_attn {

constexpr int BQ = 64, BK = 64, NWARPS = 4, NTHREADS = 32 * NWARPS;

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
// rel-pos the block's rows of the bias factors ([64][ldrh], [64][ldrw]) and
// one tile's key -> (row, column) tables.
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy, zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D = A (16x16, row) * B (16x8, col) + D, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, transposed.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + 64) x cols [0, hdp) of a [L, hd] matrix into shared
// memory with leading dimension ld; zero outside [0, L) x [0, hd). With
// `vec` (hd % 8 == 0, 16-byte aligned rows) the copy is asynchronous.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int L, int hd,
                                          int hdp, int ld, int vec) {
  if (vec) {
    const int vpr = hdp / 8;
    for (int i = threadIdx.x; i < 64 * vpr; i += NTHREADS) {
      const int r = i / vpr, c = (i % vpr) * 8;
      const bool ok = row0 + r < L && c < hd;
      cp_async16(dst + r * ld + c, ok ? src + (size_t)(row0 + r) * hd + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * hdp; i += NTHREADS) {
      const int r = i / hdp, c = i % hdp;
      dst[r * ld + c] = (row0 + r < L && c < hd) ? src[(size_t)(row0 + r) * hd + c]
                                                  : __float2bfloat16(0.f);
    }
  }
}

// CAUSAL: kv_start [B] (or null) and nh select the left pad of row bh / nh.
// Otherwise rh [BH, L, H] and rw [BH, L, W] (fp32) are the rel-pos factors:
// bias[q, key] = rh[q, key / W] + rw[q, key % W]. NKS = padded hd / 16.
template <bool CAUSAL, int NKS>
__global__ void __launch_bounds__(NTHREADS)
    attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out,
                const float* __restrict__ rh, const float* __restrict__ rw, int H, int W,
                const int* __restrict__ kv_start, int nh, int L, int hd, float scale,
                int vec) {
  constexpr int HDP = NKS * 16, LDH = HDP + 8, NDT = 2 * NKS;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout t = make_layout(hd, CAUSAL ? 0 : H, CAUSAL ? 0 : W);
  bf16* Qs = reinterpret_cast<bf16*>(smem + t.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + t.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + t.v);
  float* Rh = reinterpret_cast<float*>(smem + t.rh);
  float* Rw = reinterpret_cast<float*>(smem + t.rw);
  int* Kh = reinterpret_cast<int*>(smem + t.kh);
  int* Kw = reinterpret_cast<int*>(smem + t.kw);

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group, lane in group
  const size_t base = (size_t)bh * L * hd;

  int pad = 0;
  if (CAUSAL) {
    pad = kv_start ? kv_start[bh / nh] : 0;
  } else {
    for (int i = tid; i < BQ * H; i += NTHREADS) {
      const int r = i / H, j = i % H;
      Rh[r * t.ldrh + j] = q0 + r < L ? rh[((size_t)bh * L + q0 + r) * H + j] : 0.f;
    }
    for (int i = tid; i < BQ * W; i += NTHREADS) {
      const int r = i / W, j = i % W;
      Rw[r * t.ldrw + j] = q0 + r < L ? rw[((size_t)bh * L + q0 + r) * W + j] : 0.f;
    }
  }

  int kt_begin = 0, kt_end = (L + BK - 1) / BK;
  if (CAUSAL && q0 >= pad) {
    // no row of this block is fully masked: tiles wholly before the pad or
    // above the diagonal contribute exactly zero to every row
    kt_begin = pad / BK;
    const int last = (q0 + BQ - 1) / BK + 1;
    kt_end = last < kt_end ? last : kt_end;
  }

  // group 0: Q and the first K/V tile
  load_tile(Qs, q + base, q0, L, hd, HDP, LDH, vec);
  load_tile(Ks, k + base, kt_begin * BK, L, hd, HDP, LDH, vec);
  load_tile(Vs, v + base, kt_begin * BK, L, hd, HDP, LDH, vec);
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
      load_tile(Ks + (st ^ 1) * BK * LDH, k + base, (kt + 1) * BK, L, hd, HDP, LDH, vec);
      load_tile(Vs + (st ^ 1) * BK * LDH, v + base, (kt + 1) * BK, L, hd, HDP, LDH, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int k0 = kt * BK;
    if (!CAUSAL && tid < BK) {
      Kh[tid] = (k0 + tid) / W;
      Kw[tid] = (k0 + tid) % W;
    }
    __syncthreads();
    if (kt == kt_begin) {
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
        float v0 = s[nt][e] * scale, v1 = s[nt][2 + e] * scale;
        if (kj >= L) {
          v0 = v1 = -INFINITY;  // not a key at all: weight exactly 0
        } else if (CAUSAL) {
          if (kj > qi0 || kj < pad) v0 = -FLT_MAX;
          if (kj > qi1 || kj < pad) v1 = -FLT_MAX;
        } else {
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
        uint32_t b[4];
        ldsm_x4_trans(b, Vt + vrow * LDH + dp * 16 + (lane >> 4) * 8);
        mma16816(o[2 * dp], pa, b[0], b[1]);
        mma16816(o[2 * dp + 1], pa, b[2], b[3]);
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
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = dt * 8 + tig * 2 + e;
      if (d < hd) {
        if (qi0 < L) out[base + (size_t)qi0 * hd + d] = __float2bfloat16(o[dt][e] / l0);
        if (qi1 < L) out[base + (size_t)qi1 * hd + d] = __float2bfloat16(o[dt][2 + e] / l1);
      }
    }
  }
}

template <bool CAUSAL, int NKS>
inline int launch_nks(const void* q, const void* k, const void* v, void* out, const float* rh,
                      const float* rw, int H, int W, const int* kv_start, int nh, int BH, int L,
                      int hd, float scale, int vec, void* stream) {
  const Layout t = make_layout(hd, CAUSAL ? 0 : H, CAUSAL ? 0 : W);
  cudaError_t e = cudaFuncSetAttribute(attn_kernel<CAUSAL, NKS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)t.total);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + BQ - 1) / BQ, BH);
  attn_kernel<CAUSAL, NKS><<<grid, NTHREADS, t.total, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, rh, rw, H, W, kv_start, nh, L,
      hd, scale, vec);
  return (int)cudaGetLastError();
}

template <bool CAUSAL>
inline int launch(const void* q, const void* k, const void* v, void* out, const float* rh,
                  const float* rw, int H, int W, const int* kv_start, int nh, int BH, int L,
                  int hd, float scale, int vec, void* stream) {
  if (BH <= 0 || L <= 0) return 0;
#define ANYREF_NKS(n)                                                                       \
  case n:                                                                                   \
    return launch_nks<CAUSAL, n>(q, k, v, out, rh, rw, H, W, kv_start, nh, BH, L, hd, scale, \
                                 vec, stream);
  switch ((hd + 15) / 16) {
    ANYREF_NKS(1) ANYREF_NKS(2) ANYREF_NKS(3) ANYREF_NKS(4)
    ANYREF_NKS(5) ANYREF_NKS(6) ANYREF_NKS(7) ANYREF_NKS(8)
    default:
      return (int)cudaErrorInvalidValue;  // hd > 128 (or <= 0)
  }
#undef ANYREF_NKS
}

}  // namespace anyref_attn
