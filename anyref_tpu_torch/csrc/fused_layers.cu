// C entry of the GEMM (gemm.cuh) that, with the LayerNorm row pass of
// norms.cu (anyref_layer_norm_rows) and the rel-pos attention kernels
// (window_attention.cu for the windows, relpos_global.cu for the global
// layers), makes up the port's fused SAM layers
// (anyref_tpu_torch/ops/flash.py):
//
// * fused_window_attn   <- anyref_tpu/ops/flash.py fused_window_attn:
//   LN1 row pass with the pad mask -> GEMM(+ bias) -> window attention on
//   the heads of the fused QKV -> GEMM(+ bias + bf16 residual).
// * fused_mlp_stream    <- fused_mlp_stream: LN2 row pass -> GEMM(+ bias
//   -> GELU) -> GEMM(+ bias + bf16 residual).
// * fused_window_block  <- fused_window_block: the four launches of
//   fused_window_attn, the proj GEMM writing the residual x1 in fp32, then
//   the three of fused_mlp_stream on fp32 x1 (fp32 residual, bf16 out).
// * fused_global_tail   <- fused_global_tail: global attention off the
//   fused QKV -> GEMM(+ bias + bf16 residual -> fp32 x1) -> LN2 row pass
//   of x1 -> GEMM(+ bias -> GELU) -> GEMM(+ bias + fp32 residual -> bf16).
//
// Bound on the H100: tensor-core operations of the GEMMs (at batch 2:
// 128 GFLOP per window attention call, 257 per MLP call, 328 per global
// tail). The TPU kernels kept every intermediate in VMEM; here h, the qkv,
// the attention output and the GELU hidden go through device memory in
// bf16, which is where the TPU kernels round them, so the results are the
// same. A [128, 5120] fp32 hidden block does not fit one SM beside its
// operands.
#include "gemm.cuh"

using namespace anyref_mm;

// a [M, K] and w [K, N] bf16; bias [N] bf16 or (bias_f32) fp32. epi: 0 +
// bias, 1 + bias -> GELU, 2 + bias + residual res [M, N] (res_f32: fp32).
// out_f32: fp32 output (epilogue 2 with a bf16 residual only).
ANYREF_API int anyref_gemm(const void* a, const void* w, const void* bias, int bias_f32,
                           const void* res, void* out, int M, int N, int K, int epi, int res_f32,
                           int out_f32, void* stream) {
  Params p;
  p.bias = bias;
  p.res = res;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.bias_f32 = bias_f32;
  if (epi == E_BIAS_RES) {
    if (!res) return (int)cudaErrorInvalidValue;
    if (res_f32) return out_f32 ? (int)cudaErrorInvalidValue
                                : launch<E_BIAS_RES, true, false>(a, w, p, stream);
    return out_f32 ? launch<E_BIAS_RES, false, true>(a, w, p, stream)
                   : launch<E_BIAS_RES, false, false>(a, w, p, stream);
  }
  if (out_f32 || res_f32) return (int)cudaErrorInvalidValue;
  if (epi == E_BIAS) return launch<E_BIAS, false, false>(a, w, p, stream);
  if (epi == E_BIAS_GELU) return launch<E_BIAS_GELU, false, false>(a, w, p, stream);
  return (int)cudaErrorInvalidValue;
}
