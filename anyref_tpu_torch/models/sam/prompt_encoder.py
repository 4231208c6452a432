"""SAM prompt encoder (port of anyref_tpu/models/sam/prompt_encoder.py).

AnyRef's [SEG] projections enter as sparse embeddings, with the learned
no-mask dense embedding (encode_text_prompts). Point, box and mask prompts
(embed_points, embed_boxes, embed_masks) serve SamPredictor, the automatic
mask generator and the exported decoder. Every path is batched with static
shapes; labels are float and compared as tensors, never branched on.
"""

from __future__ import annotations

import math

import torch

from ...config import SamConfig
from ...ops.common import conv2d, gelu, layer_norm_2d


def _pe_encode(gaussian, coords):
    """Random-Fourier encoding of coords in [0, 1]^2, fp32."""
    c = coords.float() * 2.0 - 1.0
    c = c @ gaussian.float()
    c = (2.0 * math.pi) * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def dense_pe(params: dict, cfg: SamConfig):
    """[1, embed_dim, g, g] grid positional encoding."""
    g = cfg.embedding_size
    dev = params["pe_gaussian"].device
    y = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    x = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)                   # [g, g, 2] (x, y)
    pe = _pe_encode(params["pe_gaussian"], grid)
    return pe.permute(2, 0, 1)[None]


def _label_embeds(params: dict, pe, labels):
    """Fourier encodings pe [B, N, d] of points labelled [B, N] (float):
    -1 (pad) zeroes the encoding and adds not_a_point_embed, 0 (negative)
    and 1 (positive) add point_embeddings[0] and [1]."""
    lab = labels[..., None]
    pe = torch.where(lab == -1, 0.0, pe)
    pe = pe + torch.where(lab == -1, params["not_a_point_embed"][0], 0.0)
    pe = pe + torch.where(lab == 0, params["point_embeddings"][0][0], 0.0)
    return pe + torch.where(lab == 1, params["point_embeddings"][1][0], 0.0)


def embed_points(params: dict, cfg: SamConfig, coords, labels, pad: bool):
    """coords [B, N, 2] pixel coords in the image_size frame; labels [B, N]
    in {-1, 0, 1} -> [B, N (+1 with ``pad``), embed_dim] fp32. ``pad``
    appends a padding point (label -1), as SAM does without a box."""
    coords = coords.float() + 0.5
    labels = labels.float()
    if pad:
        coords = torch.cat([coords, coords.new_zeros(coords.shape[0], 1, 2)],
                           dim=1)
        labels = torch.cat([labels, -labels.new_ones(labels.shape[0], 1)],
                           dim=1)
    pe = _pe_encode(params["pe_gaussian"], coords / cfg.image_size)
    return _label_embeds(params, pe, labels)


def embed_boxes(params: dict, cfg: SamConfig, boxes):
    """boxes [B, 4] xyxy in the image_size frame -> [B, 2, embed_dim] fp32:
    the two corners' encodings plus point_embeddings[2] and [3]."""
    corners = (boxes.float().reshape(-1, 2, 2) + 0.5) / cfg.image_size
    pe = _pe_encode(params["pe_gaussian"], corners)
    corner = torch.stack([params["point_embeddings"][2][0],
                          params["point_embeddings"][3][0]]).float()
    return pe + corner


def embed_masks(params: dict, masks, eps: float = 1e-6):
    """masks [B, 1, 4g, 4g] -> [B, embed_dim, g, g]: conv 2x2 stride 2,
    LayerNorm2d, GELU, twice, then a 1x1 conv."""
    p = params["mask_downscaling"]
    x = conv2d(p["conv1"], masks, stride=(2, 2))
    x = gelu(layer_norm_2d(p["ln1"], x, eps=eps))
    x = conv2d(p["conv2"], x, stride=(2, 2))
    x = gelu(layer_norm_2d(p["ln2"], x, eps=eps))
    return conv2d(p["conv3"], x)


def no_mask_dense(params: dict, cfg: SamConfig, batch: int):
    """[B, embed_dim, g, g] learned no-mask dense embedding."""
    g = cfg.embedding_size
    return params["no_mask_embed"].reshape(1, -1, 1, 1).expand(
        batch, cfg.prompt_embed_dim, g, g)


def encode_text_prompts(params: dict, cfg: SamConfig, text_embeds):
    """text_embeds [N, T, d] -> (sparse [N, T, d], dense [N, d, g, g])."""
    return text_embeds, no_mask_dense(params, cfg, text_embeds.shape[0])
