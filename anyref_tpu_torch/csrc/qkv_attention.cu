// SAM window attention read straight off a fused [NW, ws * ws, 3C] QKV
// tensor, written head-merged [NW, ws * ws, C] (C = nh * hd), on the flash
// core of attention.cuh: the attention of anyref_tpu/ops/flash.py
// fused_window_attn (_window_attn_all), with the rel-pos factors built in
// the kernel from the gathered bf16 tables [ws, ws, hd]. The head split and
// merge of the unfused path (three [B, nh, L, hd] copies in, one out) never
// reach device memory: a block reads its head's q/k/v as column slices with
// row stride 3C and writes its head's columns of the output. Main path:
// [50, 196, 3840], 16 heads of 80, in the fused SAM layers
// (fused_layers.cu's chains). Bound: device-memory bytes (qkv in, out
// back). CLIP's bias-free attention off its fused QKV runs on
// relpos_global.cu (anyref_attention_heads).
#include "attention.cuh"

ANYREF_API int anyref_window_attention_qkv(const void* qkv, const void* th, const void* tw,
                                           void* out, int B, int L, int nh, int hd, int ws,
                                           float scale, int vec, void* stream) {
  if (ws <= 0 || ws * ws != L) return (int)cudaErrorInvalidValue;
  anyref_attn::Args a = anyref_attn::qkv_direct(qkv, out, nh, L, hd, scale, vec);
  a.H = a.W = ws;
  a.th = (const bf16*)th;
  a.tw = (const bf16*)tw;
  return anyref_attn::launch(a, B * nh, stream);
}
