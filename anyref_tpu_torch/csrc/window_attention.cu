// SAM rel-pos attention over one whole window (L = H * W <= 256 tokens):
// softmax(q k^T * scale + rh[q, key // W] + rw[q, key % W]) v, with the
// bias factors rh[q, j] = q . th[q // W, j] and rw[q, j] = q . tw[q % W, j]
// computed in the kernel from bf16 q and the bf16 gathered tables th
// [H, H, hd], tw [W, W, hd] (fp32 sums of exact bf16 products, as the
// wrappers' einsums give them up to summation order).
//
// Replaces, for L <= 256, anyref_tpu/ops/flash.py flash_relpos_attention's
// window kernel (_relpos_multihead_kernel, L < 1024),
// flash_relpos_attention_qkv (_relpos_qkv_kernel) and the window attention
// inside fused_window_attn and fused_window_block (_window_attn_all);
// longer grids go to relpos_global.cu. One launch a call, the factors
// included. One C entry takes the q/k/v and output views as strides, so it
// reads split heads [B, nh, L, hd] (or their permuted views of a fused
// QKV) and writes split heads, or reads the fused [B, L, 3C] QKV directly
// and writes [B, L, C] head-merged (the fused layers' windows: B = 50
// windows at batch 2, their gathered tables [ws * ws, hd] viewed as
// [ws, ws, hd]). P is not normalised before its bf16 rounding: the sum is
// divided by the row sum after P V (the fused layers' plain version
// normalises first; ROADMAP C1).
//
// What bounds it on the H100: device-memory bytes, in principle. At SAM-H's
// windows ([50, 196, 3840], 16 heads of 80) a call reads q, k, v once and
// writes the output once (100 MB, 0.030 ms at 3.35 TB/s) for 9.8 GFLOP
// (0.010 ms on the tensor cores). In practice the latency of short
// dependent chains sets the time, so the design reads every byte once and
// keeps as many warps in flight as shared memory and registers allow:
// - one block of eight warps per (window, head), two blocks (16 warps) a
//   SM: 111 KB of shared memory and at most 128 registers a thread;
// - Q and K go to shared memory by 16-byte cp.async (Q in V's region);
//   the bias factors are tensor-core products computed from them. Rows
//   sharing q // W = i are W consecutive queries, so rh for them is one
//   product Q_i th[i]^T (W x H x hd); rows sharing q % W = w are the
//   queries w + r W, so rw for them is Q_w tw[w]^T (H x W x hd). The A
//   fragments are gathered from shared memory by ldmatrix (each lane names
//   its own row), the table slices staged per warp, so the H + W products
//   do only the work the factors need. They land in shared memory as fp32
//   [L, H] and [L, W]; then V replaces Q;
// - a warp owns 16-row query strips (Q staged per strip) and walks the keys
//   in chunks of 32 on mma.sync.m16n8k16: Q K^T, the scale and both
//   factors, a running row max and sum in fp32 (the output rescaled when
//   the max grows, as the flash core does; holding a whole 208-key row of
//   scores took 104 registers and halved the warps a SM could run), P
//   unnormalised and rounded to bf16 as P V's A operand (V by
//   ldmatrix.trans); the output, times the reciprocal of the row sum, goes
//   through the warp's buffer to 16-byte stores. K and V rows past L are
//   read clamped to row L - 1 and weighted exactly 0.
#include "common.cuh"

namespace anyref_win {

constexpr int NWARPS = 8, NTHREADS = 32 * NWARPS, MAX_L = 256;
constexpr int CT = 4, CK = 8 * CT;  // keys are walked in chunks of CK = 32

struct Args {
  const bf16 *q, *k, *v;  // element strides of batch, head and row: sb, sh, sr
  int sb, sh, sr;
  const bf16 *th, *tw;    // [H, H, hd] and [W, W, hd], contiguous
  bf16* out;              // strides osb, osh, osr
  int osb, osh, osr;
  int nh, L, hd, H, W;
  float scale;
  int vec;                // 16-byte copies (hd, strides and bases multiples of 8)
};

__host__ __device__ inline size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

struct Layout {
  int ldh;
  size_t k, v, rh, rw, buf, total;
};

// K [L][ldh] and V [L][ldh] bf16 (ldh = hd padded to 16, + 8: the eight
// rows of an ldmatrix fall in distinct banks; V's region holds Q during
// the factor phase), the factors Rh [L][H] and Rw [L][W] fp32, and one
// [16][ldh] bf16 buffer per warp (a table slice, then a strip's Q and its
// output). At [50, 196, 3840]: 111 KB, two blocks a SM.
__host__ __device__ inline Layout make_layout(int L, int hd, int H, int W) {
  Layout t;
  t.ldh = (hd + 15) / 16 * 16 + 8;
  size_t off = 0;
  t.k = off; off += align128((size_t)L * t.ldh * 2);
  t.v = off; off += align128((size_t)L * t.ldh * 2);
  t.rh = off; off += align128((size_t)L * H * 4);
  t.rw = off; off += align128((size_t)L * W * 4);
  t.buf = off; off += align128((size_t)NWARPS * 16 * t.ldh * 2);
  t.total = off;
  return t;
}

// D += A B (m16n8k16, bf16 in, fp32 accumulate). Not volatile: a pure
// register operation the compiler may schedule freely.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [0, n) of an [n, hd] matrix with row stride ld to shared
// memory (leading dimension lds, columns [0, hdp)), zero past hd, by the
// `nthreads` threads numbered `tid`: 16-byte cp.async with `vec`, else
// element by element.
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int n, int hd, int hdp,
                                          int ld, int lds, int vec, int tid, int nthreads) {
  if (vec) {
    const int vpr = hdp / 8;
    for (int i = tid; i < n * vpr; i += nthreads) {
      const int r = i / vpr, c = (i % vpr) * 8;
      cp_async16(dst + r * lds + c, c < hd ? src + (size_t)r * ld + c : src, c < hd);
    }
  } else {
    for (int i = tid; i < n * hdp; i += nthreads) {
      const int r = i / hdp, c = i % hdp;
      dst[r * lds + c] = c < hd ? src[(size_t)r * ld + c] : __float2bfloat16(0.f);
    }
  }
}

// A warp's 16-row buffer: rows [0, n) from src, the rest zero.
__device__ __forceinline__ void copy_strip(bf16* dst, const bf16* src, int n, int hd, int hdp,
                                           int ld, int lds, int vec, int lane) {
  copy_rows(dst, src, n, hd, hdp, ld, lds, vec, lane, 32);
  for (int i = n * hdp + lane; i < 16 * hdp; i += 32)
    dst[(i / hdp) * lds + i % hdp] = __float2bfloat16(0.f);
}

// The factors of the whole window into Rh [L][H] and Rw [L][W]: H products
// for rh (rows i W + r, r < W, by th[i]) and W for rw (rows w + r W, r < H,
// by tw[w]), in 16 x 16 tiles spread over the warps. A tile's Q rows are
// gathered from shared memory by ldmatrix (each lane names its own row);
// its 16-row table slice is staged in the warp's buffer.
template <int NKS>
__device__ __forceinline__ void factors(const Args& a, const bf16* Qs, bf16* buf, float* Rh,
                                        float* Rw, int warp, int lane) {
  constexpr int HDP = NKS * 16, LDH = HDP + 8;
  const int H = a.H, W = a.W, hd = a.hd, g = lane >> 2, tig = lane & 3;
  const int mtw = (W + 15) / 16, mth = (H + 15) / 16;
  const int nth = (H + 15) / 16, ntw = (W + 15) / 16;  // 16-column slices
  const int nrh = H * mtw * nth, ntask = nrh + W * mth * ntw;
  struct Task {
    int mt, n0, M, N, base, step;
    const bf16* tab;
  };
  auto task_of = [&](int task) {
    Task k;
    if (task < nrh) {  // rh of the W queries of grid row i, by th[i]
      const int i = task / (mtw * nth), u = task % (mtw * nth);
      k = {u / nth, (u % nth) * 16, W, H, i * W, 1, a.th + (size_t)i * H * hd};
    } else {           // rw of the H queries of grid column w, by tw[w]
      const int u0 = task - nrh, w = u0 / (mth * ntw), u = u0 % (mth * ntw);
      k = {u / ntw, (u % ntw) * 16, H, W, w, W, a.tw + (size_t)w * W * hd};
    }
    return k;
  };
  auto stage = [&](int task) {
    const Task k = task_of(task);
    copy_strip(buf, k.tab + (size_t)k.n0 * hd, min(16, k.N - k.n0), hd, HDP, hd, LDH, a.vec,
               lane);
    cp_async_commit();
  };
  if (warp < ntask) stage(warp);  // in flight with Q and K
  cp_async_wait<0>();
  __syncthreads();  // Q (in V's region), K and the first slices in place
  for (int task = warp; task < ntask; task += NWARPS) {
    if (task != warp) {
      stage(task);
      cp_async_wait<0>();
    }
    __syncwarp();
    const Task k = task_of(task);
    const int lr = (lane & 7) + ((lane >> 3) & 1) * 8;  // this lane's A row
    const int qrow = k.base + min(k.mt * 16 + lr, k.M - 1) * k.step;
    const bf16* ap = Qs + qrow * LDH + (lane >> 4) * 8;
    const bf16* bp = buf + ((lane & 7) + (lane >> 4) * 8) * LDH + ((lane >> 3) & 1) * 8;
    float c[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      uint32_t af[4], bf[4];
      ldsm_x4(af, ap + ks * 16);
      ldsm_x4(bf, bp + ks * 16);
      mma_bf16(c[0], af, bf[0], bf[1]);
      mma_bf16(c[1], af, bf[2], bf[3]);
    }
    float* R = task < nrh ? Rh : Rw;
    const int ra = k.mt * 16 + g, rb = ra + 8;
    const int qa = k.base + ra * k.step, qb = k.base + rb * k.step;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = k.n0 + h * 8 + tig * 2;
      if (ra < k.M) {
        if (j < k.N) R[qa * k.N + j] = c[h][0];
        if (j + 1 < k.N) R[qa * k.N + j + 1] = c[h][1];
      }
      if (rb < k.M) {
        if (j < k.N) R[qb * k.N + j] = c[h][2];
        if (j + 1 < k.N) R[qb * k.N + j + 1] = c[h][3];
      }
    }
    __syncwarp();  // the buffer just read is refilled next
  }
}

// One 16-row strip, rows q0 .. q0 + 15, its Q in the warp's buffer bq:
// keys in chunks of CK, each scored (Q K^T, scale, both factors), folded
// into the running row max and sum (fp32, the output rescaled when the max
// grows), its P rounded to bf16 and multiplied into the output by V; the
// output divided by the row sum and written through bq.
template <int NKS>
__device__ __forceinline__ void strip(const Args& a, const bf16* Ks, const bf16* Vs,
                                      const float* Rh, const float* Rw, bf16* bq, bf16* ob,
                                      int q0, int lane) {
  constexpr int LDH = NKS * 16 + 8;
  const int L = a.L, H = a.H, W = a.W, hd = a.hd, g = lane >> 2, tig = lane & 3;
  uint32_t qf[NKS][4];
  {
    const bf16* p = bq + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDH + (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) ldsm_x4(qf[ks], p + ks * 16);
  }
  // Lane holds rows q0 + g (elements 0, 1) and q0 + g + 8 (2, 3) at keys
  // tile * 8 + tig * 2 + e. Pad rows (>= L) read the last row's factors and
  // are never stored. key // W by a multiply and shift (exact for keys and
  // W below 256); past L a key weighs exactly 0.
  const int qr0 = min(q0 + g, L - 1), qr1 = min(q0 + g + 8, L - 1);
  const float *rh0 = Rh + qr0 * H, *rh1 = Rh + qr1 * H;
  const float *rw0 = Rw + qr0 * W, *rw1 = Rw + qr1 * W;
  const uint32_t invw = (65536u + W - 1) / W;
  const int kr = (lane & 7) + (lane >> 4) * 8, kc = ((lane >> 3) & 1) * 8;
  const int vr = (lane & 7) + ((lane >> 3) & 1) * 8, vc = (lane >> 4) * 8;
  float o[2 * NKS][4];
#pragma unroll
  for (int i = 0; i < 2 * NKS; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int k0 = 0; k0 < L; k0 += CK) {
    float s[CT][4];
#pragma unroll
    for (int nt = 0; nt < CT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
#pragma unroll
      for (int j = 0; j < CT / 2; ++j) {
        uint32_t kb[4];
        ldsm_x4(kb, Ks + min(k0 + j * 16 + kr, L - 1) * LDH + kc + ks * 16);
        mma_bf16(s[2 * j], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * j + 1], qf[ks], kb[2], kb[3]);
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < CT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = k0 + nt * 8 + tig * 2 + e;
        const int kq = (int)(((uint32_t)c * invw) >> 16), kw = c - kq * W, kh = min(kq, H - 1);
        const bool key = c < L;
        const float v0 = s[nt][e] * a.scale + rh0[kh] + rw0[kw];
        const float v1 = s[nt][2 + e] * a.scale + rh1[kh] + rw1[kw];
        s[nt][e] = key ? v0 : -INFINITY;
        s[nt][2 + e] = key ? v1 : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // key k0 < L, so the new max is finite; alpha is 0 on the first chunk
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float al0 = __expf(m0 - n0), al1 = __expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < CT; ++nt) {
      s[nt][0] = __expf(s[nt][0] - n0);
      s[nt][1] = __expf(s[nt][1] - n0);
      s[nt][2] = __expf(s[nt][2] - n1);
      s[nt][3] = __expf(s[nt][3] - n1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * al0 + ps0;  // per-lane partial sums; the four lanes of a row share alpha
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int i = 0; i < 2 * NKS; ++i) {
      o[i][0] *= al0;
      o[i][1] *= al0;
      o[i][2] *= al1;
      o[i][3] *= al1;
    }
#pragma unroll
    for (int j = 0; j < CT / 2; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const bf16* vp = Vs + min(k0 + j * 16 + vr, L - 1) * LDH + vc;
#pragma unroll
      for (int dp = 0; dp < NKS; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vp + dp * 16);
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int dt = 0; dt < 2 * NKS; ++dt) {
    const int d = dt * 8 + tig * 2;
    *reinterpret_cast<uint32_t*>(bq + g * LDH + d) = pack_bf16(o[dt][0] * i0, o[dt][1] * i0);
    *reinterpret_cast<uint32_t*>(bq + (g + 8) * LDH + d) =
        pack_bf16(o[dt][2] * i1, o[dt][3] * i1);
  }
  __syncwarp();
  const int rows = min(16, L - q0);
  if (a.vec) {
    const int vpr = hd / 8;
    for (int i = lane; i < rows * vpr; i += 32) {
      const int r = i / vpr, c = (i % vpr) * 8;
      *reinterpret_cast<uint4*>(ob + (size_t)(q0 + r) * a.osr + c) =
          *reinterpret_cast<const uint4*>(bq + r * LDH + c);
    }
  } else {
    for (int i = lane; i < rows * hd; i += 32) {
      const int r = i / hd, c = i % hd;
      ob[(size_t)(q0 + r) * a.osr + c] = bq[r * LDH + c];
    }
  }
  __syncwarp();  // bq is refilled with the warp's next strip
}

template <int NKS>
__global__ void __launch_bounds__(NTHREADS, NKS <= 5 ? 2 : 1) window_kernel(const Args a) {
  constexpr int HDP = NKS * 16, LDH = HDP + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout t = make_layout(a.L, a.hd, a.H, a.W);
  bf16* Ks = reinterpret_cast<bf16*>(smem + t.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + t.v);
  float* Rh = reinterpret_cast<float*>(smem + t.rh);
  float* Rw = reinterpret_cast<float*>(smem + t.rw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, L = a.L;
  bf16* bq = reinterpret_cast<bf16*>(smem + t.buf) + warp * 16 * LDH;

  const int b = blockIdx.x / a.nh, h = blockIdx.x % a.nh;
  const size_t ib = (size_t)b * a.sb + (size_t)h * a.sh;
  const bf16* qb = a.q + ib;
  bf16* ob = a.out + (size_t)b * a.osb + (size_t)h * a.osh;

  // Q into V's region and K, both for the whole block; then the factors
  copy_rows(Vs, qb, L, a.hd, HDP, a.sr, LDH, a.vec, threadIdx.x, NTHREADS);
  copy_rows(Ks, a.k + ib, L, a.hd, HDP, a.sr, LDH, a.vec, threadIdx.x, NTHREADS);
  factors<NKS>(a, Vs, bq, Rh, Rw, warp, lane);
  __syncthreads();  // every factor in place, Q's region free

  // each warp's first strip of Q and V; every warp runs the same number of
  // rounds, so the block meets once, when V has arrived
  const int nstrips = (L + 15) / 16;
  if (warp < nstrips)
    copy_strip(bq, qb + (size_t)warp * 16 * a.sr, min(16, L - warp * 16), a.hd, HDP, a.sr, LDH,
               a.vec, lane);
  copy_rows(Vs, a.v + ib, L, a.hd, HDP, a.sr, LDH, a.vec, threadIdx.x, NTHREADS);
  cp_async_commit();
  for (int r = 0; r * NWARPS < nstrips; ++r) {
    const int st = r * NWARPS + warp, nx = st + NWARPS;
    cp_async_wait<0>();
    if (r == 0) __syncthreads();  // V in place
    __syncwarp();
    if (st < nstrips) strip<NKS>(a, Ks, Vs, Rh, Rw, bq, ob, st * 16, lane);
    if (nx < nstrips)
      copy_strip(bq, qb + (size_t)nx * 16 * a.sr, min(16, L - nx * 16), a.hd, HDP, a.sr, LDH,
                 a.vec, lane);
    cp_async_commit();
  }
}

template <int NKS>
inline int launch_t(const Args& a, int BH, void* stream) {
  const Layout t = make_layout(a.L, a.hd, a.H, a.W);
  cudaError_t e = cudaFuncSetAttribute(window_kernel<NKS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)t.total);
  if (e != cudaSuccess) return (int)e;
  window_kernel<NKS><<<BH, NTHREADS, t.total, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace anyref_win

// q/k/v: row r of head h of batch entry b at base + b * sb + h * sh + r * sr
// (the three share strides); out likewise with osb, osh, osr. th [H, H, hd]
// and tw [W, W, hd] contiguous bf16. vec: 16-byte copies (hd, every stride
// and every base a multiple of 8 elements).
ANYREF_API int anyref_window_relpos_attention(const void* q, const void* k, const void* v,
                                              int sb, int sh, int sr, const void* th,
                                              const void* tw, void* out, int osb, int osh,
                                              int osr, int B, int nh, int L, int hd, int H, int W,
                                              float scale, int vec, void* stream) {
  using namespace anyref_win;
  if (H <= 0 || W <= 0 || H * W != L || L > MAX_L || nh <= 0) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const Args a = {(const bf16*)q, (const bf16*)k, (const bf16*)v, sb, sh, sr,
                  (const bf16*)th, (const bf16*)tw, (bf16*)out, osb, osh, osr,
                  nh, L, hd, H, W, scale, vec};
#define ANYREF_NKS(n) \
  case n:             \
    return launch_t<n>(a, B * nh, stream);
  switch ((hd + 15) / 16) {
    ANYREF_NKS(1) ANYREF_NKS(2) ANYREF_NKS(3) ANYREF_NKS(4)
    ANYREF_NKS(5) ANYREF_NKS(6) ANYREF_NKS(7) ANYREF_NKS(8)
    default:
      return (int)cudaErrorInvalidValue;  // hd > 128 (or <= 0)
  }
#undef ANYREF_NKS
}
