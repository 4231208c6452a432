"""ImageBind's audio tower (port of anyref_tpu/models/imagebind/audio.py).

The audio slice of ImageBind-huge, the only modality AnyRef keeps:

  mel clips [B, S, 1, 128, 204]
    -> Conv2d(1 -> 768, k16, s10, no bias) patch stem + LN
    -> + cls token, + learned position embedding (229 tokens)
    -> 12 pre-norm blocks, attention with one learned key/value token
    -> LN -> cls row                            = audio_feature
    -> Linear(768 -> 1024, no bias) -> L2 normalize -> x 20 = embedding

The reference computes all of it outside any Pallas kernel, so the port
runs it plain: ``ops.common.mha`` and the plain LayerNorm, the stem through
``F.conv2d``. In bf16 it rounds where the reference's XLA program rounds:
each product and bias add in the activations' dtype, the softmax in fp32,
the exact GELU op by op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...config import ImageBindAudioConfig
from ...ops.common import layer_norm, linear, mha


def _patch_grid(cfg: ImageBindAudioConfig) -> tuple[int, int]:
    h = (cfg.mel_bins - cfg.kernel_size) // cfg.stride + 1
    w = (cfg.target_len - cfg.kernel_size) // cfg.stride + 1
    return h, w


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU spelled 0.5 x erfc(-x sqrt(1/2)) op by op with the
    constant in x's dtype, as jax.nn.gelu(approximate=False) is, so bf16
    rounds after each step where the reference's does."""
    sqrt_half = torch.full((), 0.5 ** 0.5, dtype=x.dtype, device=x.device)
    return (0.5 * x) * torch.special.erfc(-x * sqrt_half)


def _block(p: dict, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, L, D = x.shape
    hd = D // num_heads
    h = layer_norm(p["norm1"], x, eps=1e-6)
    q, k, v = linear(p["attn"]["qkv"], h).split(D, dim=-1)
    # add_bias_kv: one learned key/value token appended to every sequence
    # (torch nn.MultiheadAttention)
    k = torch.cat([k, p["attn"]["bias_k"].to(k.dtype).expand(B, 1, D)], 1)
    v = torch.cat([v, p["attn"]["bias_v"].to(v.dtype).expand(B, 1, D)], 1)
    qh = q.reshape(B, L, num_heads, hd).transpose(1, 2)
    kh = k.reshape(B, L + 1, num_heads, hd).transpose(1, 2)
    vh = v.reshape(B, L + 1, num_heads, hd).transpose(1, 2)
    o = mha(qh, kh, vh).transpose(1, 2).reshape(B, L, D)
    x = x + linear(p["attn"]["out"], o)
    h = layer_norm(p["norm2"], x, eps=1e-6)
    return x + linear(p["mlp"]["fc2"], _gelu(linear(p["mlp"]["fc1"], h)))


def trunk(params: dict, cfg: ImageBindAudioConfig, mels) -> torch.Tensor:
    """mels [N, 1, mel_bins, target_len] -> [N, tokens, embed_dim]."""
    w = params["patch_conv"]["w"]
    x = F.conv2d(mels.to(w.dtype), w, stride=cfg.stride)
    N, D = x.shape[:2]
    x = x.reshape(N, D, -1).transpose(1, 2)
    x = layer_norm(params["patch_norm"], x, eps=1e-6)
    cls = params["cls_token"].to(x.dtype).expand(N, 1, D)
    x = torch.cat([cls, x], 1) + params["pos_embed"].to(x.dtype)
    for bp in params["blocks"]:
        x = _block(bp, x, cfg.num_heads)
    return x


def get_audio_feature(params: dict, cfg: ImageBindAudioConfig, mels):
    """mels [B, S, 1, mel_bins, target_len] (S clips an audio) ->
    (audio_feature [B, S, embed_dim], embedding [B, S, out_embed_dim]): the
    embedding L2-normalised in fp32 (norm floored at 1e-12), scaled by
    ``logit_scale_init`` and cast back to the head's dtype."""
    B, S = mels.shape[:2]
    x = trunk(params, cfg, mels.reshape(B * S, *mels.shape[2:]))
    feat = layer_norm(params["head_norm"], x[:, 0], eps=1e-6)   # cls row
    emb = linear(params["head_proj"], feat)
    emb_f = emb.float()
    emb_f = emb_f / torch.linalg.vector_norm(
        emb_f, dim=-1, keepdim=True).clamp_min(1e-12)
    emb_f = emb_f * cfg.logit_scale_init
    return feat.reshape(B, S, -1), emb_f.reshape(B, S, -1).to(emb.dtype)
