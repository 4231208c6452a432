"""SAM ViTDet image encoder (port of anyref_tpu/models/sam/image_encoder.py
apply, fused and unfused paths).

Windowed attention (size 14) with global layers at
cfg.encoder_global_attn_indexes, decomposed relative-position bias, absolute
position embeddings and an fp32 conv neck to 256 channels. The windowed run
keeps the stream window-resident [B*nw, ws, ws, C] and re-zeroes the pad
positions after every LN1, as the reference does.

Four paths (config.ENCODER_PATHS), chosen by the caller:
* "unfused": each block op by op, LN1/LN2 in the LayerNorm kernel and
  attention in the rel-pos attention kernel (ops/flash.py);
* "unfused_qkv": as "unfused", but attention over a grid of 64 <= H * W <
  1024 tokens (flash.supported_relpos_qkv: the windows, and the global
  layer of anyref_tiny()) reads q/k/v straight off the fused QKV
  (flash_relpos_attention_qkv);
* "fused": the reference's accelerator default. A window layer is
  fused_window_attn + fused_mlp_stream where 64 <= ws^2 <= 1024, a global
  layer LN1 (LayerNorm kernel) + QKV matmul + fused_global_tail where
  flash.supported_global_fused takes the grid; the reference's gates, so
  each shape gets the reference's numerics. Where a gate refuses, the block
  runs as on the unfused path;
* "fused_block": as "fused", with a window layer as one fused_window_block.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...config import SamConfig, check_encoder_path
from ...ops import flash
from ...ops.attention import attention_with_decomposed_relpos
from ...ops.common import conv2d, gelu, layer_norm, layer_norm_2d, linear


def _get_rel_pos_table(size: int, rel_pos):
    """[2*size-1, hd] table -> [q, k, hd] gathered bias factors."""
    coords = np.arange(size)[:, None] - np.arange(size)[None, :] + size - 1
    return rel_pos[torch.as_tensor(coords, device=rel_pos.device)]


def _attn_block(p, x, num_heads: int, size_hw: tuple[int, int],
                qkv_direct: bool = False):
    """Attention over [B, H, W, C] tokens with decomposed rel-pos bias.
    ``qkv_direct`` (the "unfused_qkv" path) reads q/k/v off the fused QKV
    where the reference's gate takes the grid."""
    B, H, W, C = x.shape
    hd = C // num_heads
    rh = _get_rel_pos_table(size_hw[0], p["rel_pos_h"])
    rw = _get_rel_pos_table(size_hw[1], p["rel_pos_w"])
    if qkv_direct and flash.supported_relpos_qkv(*size_hw):
        qkv = linear(p["qkv"], x).reshape(B, H * W, 3 * C)
        out = flash.flash_relpos_attention_qkv(qkv, rh, rw, size_hw,
                                               num_heads)
        return linear(p["proj"], out.reshape(B, H, W, C))
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


def _block(p, x, cfg: SamConfig, qkv_direct: bool):
    """Global-attention block on [B, H, W, C]."""
    shortcut = x
    x = layer_norm(p["norm1"], x, eps=cfg.layer_norm_eps, fused=True)
    x = _attn_block(p["attn"], x, cfg.encoder_num_heads,
                    (x.shape[1], x.shape[2]), qkv_direct)
    x = shortcut + x
    h = layer_norm(p["norm2"], x, eps=cfg.layer_norm_eps, fused=True)
    h = linear(p["mlp"]["lin2"], gelu(linear(p["mlp"]["lin1"], h)))
    return x + h


def _block_windowed_resident(p, xw, mask, cfg: SamConfig, qkv_direct: bool):
    """Windowed block on the window-resident stream [B*nw, ws, ws, C]; the
    pad ``mask`` re-zeroes pad positions after LN1 (the reference re-pads
    the post-norm1 values with zeros every layer)."""
    shortcut = xw
    h = layer_norm(p["norm1"], xw, eps=cfg.layer_norm_eps, fused=True) * mask
    h = _attn_block(p["attn"], h, cfg.encoder_num_heads,
                    (cfg.window_size, cfg.window_size), qkv_direct)
    x = shortcut + h
    h = layer_norm(p["norm2"], x, eps=cfg.layer_norm_eps, fused=True)
    h = linear(p["mlp"]["lin2"], gelu(linear(p["mlp"]["lin1"], h)))
    return x + h


def fused_window_ok(cfg: SamConfig) -> bool:
    """The reference's gate for its fused window layer (image_encoder.py
    _fused_window_layer_enabled with the kernels on)."""
    return 64 <= cfg.window_size ** 2 <= 1024


def _fused_window_layer(p, xw, cfg: SamConfig, grid_hw, nwc: int,
                        block: bool):
    """Window layer on the window-resident stream [NW, ws*ws, C]: LN1 + pad
    mask + QKV + rel-pos attention + proj + residual, then LN2 + MLP +
    residual. ``block``: in one fused_window_block (the reference's
    ANYREF_FUSED_SPLIT=0); else its split variant (=1), the attention half
    then the MLP half over the flat rows."""
    ws = cfg.window_size
    tht = _get_rel_pos_table(ws, p["attn"]["rel_pos_h"]).reshape(ws * ws, -1)
    twt = _get_rel_pos_table(ws, p["attn"]["rel_pos_w"]).reshape(ws * ws, -1)
    if block:
        return flash.fused_window_block(
            xw, p["norm1"], p["attn"]["qkv"], tht, twt, p["attn"]["proj"],
            p["norm2"], p["mlp"]["lin1"], p["mlp"]["lin2"], (ws, ws),
            cfg.encoder_num_heads, grid_hw, nwc, cfg.layer_norm_eps)
    NW, L, C = xw.shape
    x1 = flash.fused_window_attn(xw, p["norm1"], p["attn"]["qkv"], tht, twt,
                                 p["attn"]["proj"], (ws, ws),
                                 cfg.encoder_num_heads, grid_hw, nwc,
                                 cfg.layer_norm_eps)
    return flash.fused_mlp_stream(x1.reshape(NW * L, C), p["norm2"],
                                  p["mlp"]["lin1"], p["mlp"]["lin2"],
                                  cfg.layer_norm_eps).reshape(NW, L, C)


def _fused_global_layer(p, x, cfg: SamConfig):
    """Global block: LN1 in the LayerNorm kernel and the QKV projection as a
    matmul (the reference keeps both outside its kernel), then
    fused_global_tail."""
    B, H, W, C = x.shape
    tht = _get_rel_pos_table(H, p["attn"]["rel_pos_h"])
    twt = _get_rel_pos_table(W, p["attn"]["rel_pos_w"])
    h = layer_norm(p["norm1"], x, eps=cfg.layer_norm_eps, fused=True)
    qkv = linear(p["attn"]["qkv"], h.reshape(B, H * W, C))
    out = flash.fused_global_tail(x.reshape(B, H * W, C), qkv, tht, twt,
                                  p["attn"]["proj"], p["norm2"],
                                  p["mlp"]["lin1"], p["mlp"]["lin2"], (H, W),
                                  cfg.encoder_num_heads, cfg.layer_norm_eps)
    return out.reshape(B, H, W, C)


def patch_embed(p, x, patch: int):
    """[B, 3, H, W] -> [B, H/ps, W/ps, D] via reshape + matmul."""
    B, C, H, W = x.shape
    gh, gw = H // patch, W // patch
    x = x.reshape(B, C, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, gh, gw, C * patch * patch)
    return linear(p, x)


def apply(params: dict, x, cfg: SamConfig, encoder_path: str = "fused"):
    """[B, 3, image_size, image_size] normalized pixels -> [B, 256, g, g]
    image embeddings, computed in the param dtype; fp32 neck.
    ``encoder_path``: one of config.ENCODER_PATHS (the module docstring)."""
    path = check_encoder_path(encoder_path)
    fused = path in ("fused", "fused_block")
    qkv_direct = path == "unfused_qkv"
    x = x.to(params["patch_embed"]["w"].dtype)
    x = patch_embed(params["patch_embed"], x, cfg.patch_size)
    x = x + params["pos_embed"].to(x.dtype)
    B, H, W = x.shape[0], x.shape[1], x.shape[2]
    ws = cfg.window_size
    pad_mask, _ = _window_partition(
        torch.ones((1, H, W, 1), dtype=x.dtype, device=x.device), ws)
    fused_window = fused and fused_window_ok(cfg)
    fused_global = fused and flash.supported_global_fused(
        H, W, x.shape[-1] // cfg.encoder_num_heads)
    win_x = pad_hw = mask = None
    for i, bp in enumerate(params["blocks"]):
        if i in cfg.encoder_global_attn_indexes:
            if win_x is not None:
                x = _window_unpartition(win_x, ws, pad_hw, (H, W))
                win_x = None
            x = (_fused_global_layer(bp, x, cfg) if fused_global
                 else _block(bp, x, cfg, qkv_direct))
        else:
            if win_x is None:
                win_x, pad_hw = _window_partition(x, ws)
                mask = pad_mask.repeat(B, 1, 1, 1)
            if fused_window:
                win_x = _fused_window_layer(
                    bp, win_x.reshape(win_x.shape[0], ws * ws, -1), cfg,
                    (H, W), pad_hw[1] // ws,
                    block=path == "fused_block").reshape(win_x.shape)
            else:
                win_x = _block_windowed_resident(bp, win_x, mask, cfg,
                                                 qkv_direct)
    if win_x is not None:
        x = _window_unpartition(win_x, ws, pad_hw, (H, W))
    # fp32 island for the neck
    y = x.float().permute(0, 3, 1, 2)
    y = conv2d(params["neck"]["conv1"], y)
    y = layer_norm_2d(params["neck"]["ln1"], y, eps=cfg.layer_norm_eps)
    y = conv2d(params["neck"]["conv2"], y, padding=1)
    y = layer_norm_2d(params["neck"]["ln2"], y, eps=cfg.layer_norm_eps)
    return y.to(x.dtype)
