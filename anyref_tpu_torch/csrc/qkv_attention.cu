// Attention read straight off a fused [B, L, 3C] QKV tensor, written
// head-merged [B, L, C] (C = nh * hd), on the flash core of attention.cuh.
// The head split and merge of the unfused path (three [B, nh, L, hd] copies
// in, one out) never reach device memory: a block reads its head's q/k/v as
// column slices with row stride 3C and writes its head's columns of the
// output.
//
// * anyref_window_attention_qkv: the attention of
//   anyref_tpu/ops/flash.py fused_window_attn (_window_attn_all), SAM
//   windows [NW, ws*ws, 3C] with the rel-pos factors built in the kernel
//   from the gathered bf16 tables [ws, ws, hd]. Main path: [50, 196, 3840],
//   16 heads of 80. Bound: device-memory bytes (qkv in, out back).
// * anyref_mha_qkv: flash_attention_qkv (_mha_qkv_kernel), CLIP's bias-free
//   attention. Main path: [2, 257, 3072], 16 heads of 64. Bound: bytes.
#include "attention.cuh"

ANYREF_API int anyref_window_attention_qkv(const void* qkv, const void* th, const void* tw,
                                           void* out, int B, int L, int nh, int hd, int ws,
                                           float scale, int vec, void* stream) {
  if (ws <= 0 || ws * ws != L) return (int)cudaErrorInvalidValue;
  anyref_attn::Args a = anyref_attn::qkv_direct(qkv, out, nh, L, hd, scale, vec);
  a.H = a.W = ws;
  a.th = (const bf16*)th;
  a.tw = (const bf16*)tw;
  return anyref_attn::launch<anyref_attn::WINDOW>(a, B * nh, stream);
}

ANYREF_API int anyref_mha_qkv(const void* qkv, void* out, int B, int L, int nh, int hd,
                              float scale, int vec, void* stream) {
  const anyref_attn::Args a = anyref_attn::qkv_direct(qkv, out, nh, L, hd, scale, vec);
  return anyref_attn::launch<anyref_attn::NONE>(a, B * nh, stream);
}
