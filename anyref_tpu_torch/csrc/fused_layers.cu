// C entries of the GEMM and row-moment kernels (gemm.cuh) that, with the
// QKV-direct attention of qkv_attention.cu, make up the port's fused SAM
// layers (anyref_tpu_torch/ops/flash.py):
//
// * fused_window_attn   <- anyref_tpu/ops/flash.py fused_window_attn:
//   row stats -> GEMM(LN1 + pad-mask prologue, + bias) -> window attention
//   off the fused QKV -> GEMM(+ bias + bf16 residual).
// * fused_mlp_stream    <- fused_mlp_stream: row stats -> GEMM(LN2
//   prologue, + bias -> GELU) -> GEMM(+ bias + bf16 residual).
// * fused_global_tail   <- fused_global_tail: global attention off the
//   fused QKV -> GEMM(+ bias + bf16 residual -> fp32 x1) -> row stats of x1
//   -> GEMM(LN2 prologue on fp32 A, + bias -> GELU) -> GEMM(+ bias + fp32
//   residual -> bf16).
//
// Bound on the H100: tensor-core operations of the GEMMs (at batch 2:
// 128 GFLOP per window attention call, 257 per MLP call, 328 per global
// tail). The TPU kernels kept every intermediate in VMEM; here the qkv,
// attention output and GELU hidden go through device memory in bf16, which
// is where the TPU kernels round them, so the results are the same. A
// [128, 5120] fp32 hidden block does not fit one SM beside its operands.
#include "gemm.cuh"

using namespace anyref_mm;

ANYREF_API int anyref_row_stats(const void* x, void* stats, int M, int K, float eps, int x_f32,
                                void* stream) {
  if (M <= 0) return 0;
  if (K <= 0 || K % 8) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + 7) / 8);
  if (x_f32)
    row_stats_kernel<float><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float2*)stats, M, K, eps);
  else
    row_stats_kernel<bf16><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (float2*)stats, M, K, eps);
  return (int)cudaGetLastError();
}

// amode: 0 bf16 A, 1 LayerNorm of bf16 A, 2 LayerNorm of fp32 A.
// epi: 0 + bias, 1 + bias -> GELU, 2 + bias + residual (res_f32: fp32
// residual). out_f32: fp32 output (epilogue 2 only).
ANYREF_API int anyref_gemm(const void* a, const void* b, const void* bias, const void* res,
                           void* out, int M, int N, int K, const void* stats,
                           const void* ln_scale, const void* ln_bias, int win_L, int win_nw,
                           int win_nwc, int ws, int grid_h, int grid_w, int amode, int epi,
                           int res_f32, int out_f32, void* stream) {
  Params p;
  p.a = a;
  p.b = (const bf16*)b;
  p.bias = (const float*)bias;
  p.res = res;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.stats = (const float2*)stats;
  p.ln_scale = (const float*)ln_scale;
  p.ln_bias = (const float*)ln_bias;
  p.win_L = win_L;
  p.win_nw = win_nw;
  p.win_nwc = win_nwc;
  p.ws = ws;
  p.grid_h = grid_h;
  p.grid_w = grid_w;
  if (ws > 0 && (win_L <= 0 || win_nw <= 0 || win_nwc <= 0)) return (int)cudaErrorInvalidValue;
  if (epi == E_BIAS_RES) {
    if (amode != A_BF16) return (int)cudaErrorInvalidValue;
    if (res_f32) return out_f32 ? (int)cudaErrorInvalidValue
                                : launch<A_BF16, E_BIAS_RES, true, false>(p, stream);
    return out_f32 ? launch<A_BF16, E_BIAS_RES, false, true>(p, stream)
                   : launch<A_BF16, E_BIAS_RES, false, false>(p, stream);
  }
  if (out_f32 || res_f32) return (int)cudaErrorInvalidValue;
  switch (amode * 2 + epi) {
    case A_BF16 * 2 + E_BIAS: return launch<A_BF16, E_BIAS, false, false>(p, stream);
    case A_LN_BF16 * 2 + E_BIAS: return launch<A_LN_BF16, E_BIAS, false, false>(p, stream);
    case A_LN_BF16 * 2 + E_BIAS_GELU: return launch<A_LN_BF16, E_BIAS_GELU, false, false>(p, stream);
    case A_LN_F32 * 2 + E_BIAS_GELU: return launch<A_LN_F32, E_BIAS_GELU, false, false>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
