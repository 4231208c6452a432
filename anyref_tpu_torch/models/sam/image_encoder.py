"""SAM ViTDet image encoder (port of the unfused path of
anyref_tpu/models/sam/image_encoder.py apply).

Windowed attention (size 14) with global layers at
cfg.encoder_global_attn_indexes, decomposed relative-position bias, absolute
position embeddings and an fp32 conv neck to 256 channels. The windowed run
keeps the stream window-resident [B*nw, ws, ws, C] and re-zeroes the pad
positions after every LN1, as the reference does. LN1/LN2 run the LayerNorm
kernel and attention the rel-pos attention kernel (ops/flash.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...config import SamConfig
from ...ops.attention import attention_with_decomposed_relpos
from ...ops.common import conv2d, gelu, layer_norm, layer_norm_2d, linear


def _get_rel_pos_table(size: int, rel_pos):
    """[2*size-1, hd] table -> [q, k, hd] gathered bias factors."""
    coords = np.arange(size)[:, None] - np.arange(size)[None, :] + size - 1
    return rel_pos[torch.as_tensor(coords, device=rel_pos.device)]


def _attn_block(p, x, num_heads: int, size_hw: tuple[int, int]):
    """Attention over [B, H, W, C] tokens with decomposed rel-pos bias."""
    B, H, W, C = x.shape
    hd = C // num_heads
    rh = _get_rel_pos_table(size_hw[0], p["rel_pos_h"])
    rw = _get_rel_pos_table(size_hw[1], p["rel_pos_w"])
    qkv = linear(p["qkv"], x).reshape(B, H * W, 3, num_heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)           # each [B, heads, HW, hd]
    out = attention_with_decomposed_relpos(q, k, v, rh, rw, size_hw)
    out = out.transpose(1, 2).reshape(B, H, W, C)
    return linear(p["proj"], out)


def _window_partition(x, ws: int):
    """[B, H, W, C] -> [B*nw, ws, ws, C] with zero padding."""
    B, H, W, C = x.shape
    pad_h = (ws - H % ws) % ws
    pad_w = (ws - W % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)
    return x, (Hp, Wp)


def _window_unpartition(wins, ws: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = wins.shape[0] // (Hp * Wp // ws // ws)
    x = wins.reshape(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def _block(p, x, cfg: SamConfig):
    """Global-attention block on [B, H, W, C]."""
    shortcut = x
    x = layer_norm(p["norm1"], x, eps=cfg.layer_norm_eps, fused=True)
    x = _attn_block(p["attn"], x, cfg.encoder_num_heads,
                    (x.shape[1], x.shape[2]))
    x = shortcut + x
    h = layer_norm(p["norm2"], x, eps=cfg.layer_norm_eps, fused=True)
    h = linear(p["mlp"]["lin2"], gelu(linear(p["mlp"]["lin1"], h)))
    return x + h


def _block_windowed_resident(p, xw, mask, cfg: SamConfig):
    """Windowed block on the window-resident stream [B*nw, ws, ws, C]; the
    pad ``mask`` re-zeroes pad positions after LN1 (the reference re-pads
    the post-norm1 values with zeros every layer)."""
    shortcut = xw
    h = layer_norm(p["norm1"], xw, eps=cfg.layer_norm_eps, fused=True) * mask
    h = _attn_block(p["attn"], h, cfg.encoder_num_heads,
                    (cfg.window_size, cfg.window_size))
    x = shortcut + h
    h = layer_norm(p["norm2"], x, eps=cfg.layer_norm_eps, fused=True)
    h = linear(p["mlp"]["lin2"], gelu(linear(p["mlp"]["lin1"], h)))
    return x + h


def patch_embed(p, x, patch: int):
    """[B, 3, H, W] -> [B, H/ps, W/ps, D] via reshape + matmul."""
    B, C, H, W = x.shape
    gh, gw = H // patch, W // patch
    x = x.reshape(B, C, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, gh, gw, C * patch * patch)
    return linear(p, x)


def apply(params: dict, x, cfg: SamConfig):
    """[B, 3, image_size, image_size] normalized pixels -> [B, 256, g, g]
    image embeddings, computed in the param dtype; fp32 neck."""
    x = x.to(params["patch_embed"]["w"].dtype)
    x = patch_embed(params["patch_embed"], x, cfg.patch_size)
    x = x + params["pos_embed"].to(x.dtype)
    B, H, W = x.shape[0], x.shape[1], x.shape[2]
    ws = cfg.window_size
    pad_mask, _ = _window_partition(
        torch.ones((1, H, W, 1), dtype=x.dtype, device=x.device), ws)
    win_x = pad_hw = mask = None
    for i, bp in enumerate(params["blocks"]):
        if i in cfg.encoder_global_attn_indexes:
            if win_x is not None:
                x = _window_unpartition(win_x, ws, pad_hw, (H, W))
                win_x = None
            x = _block(bp, x, cfg)
        else:
            if win_x is None:
                win_x, pad_hw = _window_partition(x, ws)
                mask = pad_mask.repeat(B, 1, 1, 1)
            win_x = _block_windowed_resident(bp, win_x, mask, cfg)
    if win_x is not None:
        x = _window_unpartition(win_x, ws, pad_hw, (H, W))
    # fp32 island for the neck
    y = x.float().permute(0, 3, 1, 2)
    y = conv2d(params["neck"]["conv1"], y)
    y = layer_norm_2d(params["neck"]["ln1"], y, eps=cfg.layer_norm_eps)
    y = conv2d(params["neck"]["conv2"], y, padding=1)
    y = layer_norm_2d(params["neck"]["ln2"], y, eps=cfg.layer_norm_eps)
    return y.to(x.dtype)
