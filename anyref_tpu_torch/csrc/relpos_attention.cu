// SAM ViTDet attention with decomposed relative-position bias:
// softmax(q k^T * scale + rh[q, key // W] + rw[q, key % W]) v.
//
// Replaces anyref_tpu/ops/flash.py flash_relpos_attention on grids of more
// than 256 tokens: its query-blocked global kernel (_relpos_kernel), main
// path [B, 16, 4096, 80]. Windows (L <= 256, the reference's
// _relpos_multihead_kernel) go to window_attention.cu, which holds a whole
// window in one block and computes the factors itself.
//
// Bound on the H100: tensor-core operations (4 * BH * L^2 * hd). The bias is
// never expanded to [L, L]: the block keeps its 64 rows of the [L, H] and
// [L, W] factors in shared memory and adds the two terms per key as it scores
// a tile (see attention.cuh for the tiling and the online softmax).
#include "attention.cuh"

ANYREF_API int anyref_relpos_attention(const void* q, const void* k, const void* v,
                                       const void* rh, const void* rw, void* out, int B, int nh,
                                       int L, int hd, int H, int W, float scale, int vec,
                                       void* stream) {
  if (H <= 0 || W <= 0 || H * W != L) return (int)cudaErrorInvalidValue;
  anyref_attn::Args a = anyref_attn::split_heads(q, k, v, out, nh, L, hd, scale, vec);
  a.H = H;
  a.W = W;
  a.rh = (const float*)rh;
  a.rw = (const float*)rw;
  return anyref_attn::launch<anyref_attn::RELPOS>(a, B * nh, stream);
}
