"""CLIP ViT-L/14 vision tower (port of anyref_tpu/models/clip_vit.py).

LLaVA consumes the penultimate layer's hidden states with the CLS token
dropped. Attention runs off the fused QKV tensor: on the "fused",
"fused_block" and "unfused_qkv" encoder paths in the QKV-direct kernel (the
reference's ANYREF_QKV_MHA_KERNEL=1), on the "unfused" path split into
heads and plain (=0).
"""

from __future__ import annotations

import torch

from ..config import ClipVisionConfig, check_encoder_path
from ..ops.attention import mha_qkv
from ..ops.common import layer_norm, linear, quick_gelu

CLIP_PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)


def _encoder_layer(p, x, cfg: ClipVisionConfig, encoder_path: str):
    h = layer_norm(p["ln1"], x, eps=cfg.layer_norm_eps)
    qkv = torch.cat([linear(p["attn"]["q"], h), linear(p["attn"]["k"], h),
                     linear(p["attn"]["v"], h)], dim=-1)
    o = mha_qkv(qkv, cfg.num_heads, kernel=encoder_path != "unfused")
    x = x + linear(p["attn"]["out"], o)
    h = layer_norm(p["ln2"], x, eps=cfg.layer_norm_eps)
    h = linear(p["mlp"]["fc2"], quick_gelu(linear(p["mlp"]["fc1"], h)))
    return x + h


def apply_patch_features(params: dict, pixels, cfg: ClipVisionConfig,
                         encoder_path: str = "fused"):
    """[B, 3, 224, 224] CLIP-normalized pixels -> [B, 256, hidden] patch
    features of hidden_states[select_layer], CLS dropped. ``encoder_path``:
    see config.ENCODER_PATHS."""
    check_encoder_path(encoder_path)
    B = pixels.shape[0]
    ps = cfg.patch_size
    grid = cfg.image_size // ps
    pixels = pixels.to(params["patch_embed"]["w"].dtype)
    x = pixels.reshape(B, 3, grid, ps, grid, ps)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, grid * grid, 3 * ps * ps)
    x = linear(params["patch_embed"], x)
    cls = params["class_embedding"].to(x.dtype)[None, None].expand(
        B, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + params["position_embedding"].to(x.dtype)[None]
    x = layer_norm(params["pre_layernorm"], x, eps=cfg.layer_norm_eps)
    # hidden_states[select_layer] is the input of layer
    # num_layers + select_layer + 1
    n_run = cfg.num_layers + cfg.select_layer + 1
    for p in params["layers"][:n_run]:
        x = _encoder_layer(p, x, cfg, encoder_path)
    return x[:, 1:]


def normalize_pixels(x):
    """RGB uint8-range [..., 3, H, W] -> CLIP-normalized."""
    mean = torch.tensor(CLIP_PIXEL_MEAN, dtype=x.dtype,
                        device=x.device).reshape(-1, 1, 1)
    std = torch.tensor(CLIP_PIXEL_STD, dtype=x.dtype,
                       device=x.device).reshape(-1, 1, 1)
    return (x / 255.0 - mean) / std
