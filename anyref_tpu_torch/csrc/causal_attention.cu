// Causal prefill attention with a per-row left pad (kv_start).
//
// anyref_causal_attention replaces anyref_tpu/ops/flash.py
// flash_causal_attention, both its multi-head kernel (_causal_mh_kernel) and
// its per-(batch, head) kernel (_causal_kernel). Main-path shape:
// [B, 32, L, 128] with L = prompt bucket + 255 rounded up to 128 by the
// caller (384..768).
//
// With a non-null lse it is also the forward of the training attention,
// flash_causal_attention_diff (_causal_fwd_kernel): the same kernel with the
// LSE template flag, so it also writes each row's log-sum-exp [B*nh, L] fp32
// for the backward (causal_attention_bwd.cu). Main-path shape at training:
// [2, 32, 768, 128] (L = 512 + 255 = 767 padded to 768).
//
// Bound on the H100: tensor-core operations of the unmasked (query, key)
// pairs. Tiles wholly above the diagonal or before the pad are skipped for
// blocks without fully masked rows; a block holding left-pad rows walks every
// tile so those rows get the reference's uniform mean of V over all keys
// (masked logits are float32.min, the denominator is clamped at 1e-20). See
// attention.cuh for the tiling and the online softmax.
#include "attention.cuh"

ANYREF_API int anyref_causal_attention(const void* q, const void* k, const void* v,
                                       const void* kv_start, void* out, void* lse, int B,
                                       int nh, int L, int hd, float scale, int vec,
                                       void* stream) {
  anyref_attn::Args a = anyref_attn::split_heads(q, k, v, out, nh, L, hd, scale, vec);
  a.kv_start = (const int*)kv_start;
  a.lse = (float*)lse;
  if (lse) return anyref_attn::launch<anyref_attn::CAUSAL, true>(a, B * nh, stream);
  return anyref_attn::launch<anyref_attn::CAUSAL>(a, B * nh, stream);
}
